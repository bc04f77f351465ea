"""The fusion MLP's training API and the fusion trainer against the JAX
package on the CPU.

- ``FusionMLP.forward`` for all seven modality combinations within 1e-5 of
  JAX's ``__call__``, in serving and under dropout; ``compute_loss``
  within 1e-6; the dropout masks of ``_fuse3`` and ``_fuse2`` bit-equal to
  flax's (the one ``drop`` scope, its n-th call at count n); the
  gradients within 1e-5 of the largest of ``jax.grad``'s;
- ``init_params`` bit-equal to JAX's init, ``flax_init.split`` bit-equal to
  ``jax.random.split``;
- ``save_checkpoint`` / ``load_checkpoint`` across the two packages, and
  create-if-missing;
- ``train`` at ``hidden_dim=32`` on 16 train and 8 val records made here:
  per-epoch losses within 1e-4 relative of JAX's (one-device mesh), the
  same early stop, and resume from a state the other package wrote.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

import flax.linen.stochastic as flax_stochastic
from msa_tpu.models import fusion as JF
from msa_tpu.parallel import mesh as mesh_lib
from msa_tpu.training import train_fusion as JTF
from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.models import fusion as PF
from msa_tpu_torch.models import transformer as PT
from msa_tpu_torch.training import train_fusion as PTF
from torch_parity import flat_tree, same_tree, to_numpy

HIDDEN, SEED, B = 32, 3, 4
KEY = 11  # the dropout key's seed
DIMS = (27, 31, 783)


@pytest.fixture(scope="module")
def pair():
    """JAX's init of a 32-wide fusion MLP and the port's module carrying it."""
    jm = JF.FusionMLP(hidden_dim=HIDDEN)
    params = jax.jit(lambda: JF._init_host(jm, SEED))()  # JAX's init, compiled once
    pm = PF.FusionMLP(hidden_dim=HIDDEN)
    weights.load_flax_tree(pm, to_numpy(params))
    return jm, params, pm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    face, audio, text = (rng.normal(size=(B, d)).astype(np.float32) for d in DIMS)
    t = rng.random((B, 7)).astype(np.float32)
    t[0, 2] = 0.0  # the t > 0 guard
    return face, audio, text, t / t.sum(1, keepdims=True)


def test_init_params_is_jax_init_bit_for_bit(pair):
    _, params, _ = pair
    same_tree(weights.flax_tree(PF.init_params(PF.FusionMLP(hidden_dim=HIDDEN), SEED)), to_numpy(params))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_split_is_jax_random_split(seed):
    key = jax.random.PRNGKey(seed)
    for num in (2, 3):
        want = [tuple(int(x) for x in np.asarray(k)) for k in jax.random.split(key, num)]
        assert list(flax_init.split(flax_init.prng_key(seed), num)) == want
    rng, port = key, flax_init.prng_key(seed)
    for _ in range(4):  # the trainer's stream: rng, step_rng = split(rng)
        rng, step = jax.random.split(rng)
        port, pstep = flax_init.split(port)
        assert pstep == tuple(int(x) for x in np.asarray(step))


COMBOS = [(f, a, t) for f in (0, 1) for a in (0, 1) for t in (0, 1) if f + a + t]


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "".join(n for n, on in zip("fat", c) if on))
@pytest.mark.parametrize("train", [False, True], ids=["serving", "dropout"])
def test_forward_matches_jax(pair, combo, train):
    jm, params, pm = pair
    x = _inputs()[:3]
    args = [v if on else None for v, on in zip(x, combo)]
    rngs = {"dropout": jax.random.PRNGKey(KEY)} if train else {}
    want = jm.apply({"params": params}, *args, deterministic=not train, rngs=rngs)
    got = pm(*[None if v is None else torch.from_numpy(v) for v in args], deterministic=not train, dropout_rng=KEY)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k].detach().numpy() - np.asarray(want[k])).max() <= 1e-5, k
    assert ("fused" in got) == (sum(combo) >= 2)


def test_forward_without_a_modality_or_key_raises(pair):
    _, _, pm = pair
    with pytest.raises(ValueError, match="no modality"):
        pm()
    with pytest.raises(ValueError, match="dropout key"):
        pm(*map(torch.from_numpy, _inputs()[:3]), deterministic=False)


@pytest.mark.parametrize("train", [False, True], ids=["serving", "dropout"])
def test_compute_loss_matches_jax(pair, train):
    jm, params, pm = pair
    x = _inputs()
    jl, jp = JF.compute_loss(jm, params, *x, dropout_rng=jax.random.PRNGKey(KEY) if train else None)
    pl, pp = PF.compute_loss(pm, *map(torch.from_numpy, x), dropout_rng=KEY if train else None)
    assert abs(pl.item() - float(jl)) <= 1e-6
    assert np.abs(pp.detach().numpy() - np.asarray(jp)).max() <= 1e-6


@pytest.mark.parametrize("n_mod", [3, 2], ids=["fuse3", "fuse2"])
def test_dropout_masks_are_flax_masks(pair, n_mod, monkeypatch):
    jm, params, pm = pair
    x = list(_inputs()[:3])
    if n_mod == 2:
        x[1] = None  # face + text: _fuse2's six draws
    jmasks, pmasks = [], []
    bern = flax_stochastic.random.bernoulli
    monkeypatch.setattr(flax_stochastic.random, "bernoulli", lambda *a, **k: jmasks.append(np.asarray(bern(*a, **k))) or jmasks[-1])
    mask_fn = PT.dropout_mask
    monkeypatch.setattr(PT, "dropout_mask", lambda *a, **k: pmasks.append(mask_fn(*a, **k)) or pmasks[-1])
    jm.apply({"params": params}, *x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(KEY)})
    pm(*[None if v is None else torch.from_numpy(v) for v in x], deterministic=False, dropout_rng=KEY)
    assert len(jmasks) == len(pmasks) == (8 if n_mod == 3 else 6)
    for j, p in zip(jmasks, pmasks):
        np.testing.assert_array_equal(p.numpy(), j)
    assert 0.5 < np.mean([m.mean() for m in jmasks]) < 0.9  # keep 0.7


def test_gradients_match_jax(pair):
    jm, params, pm = pair
    x = _inputs(1)
    key = jax.random.PRNGKey(KEY)
    grads = flat_tree(to_numpy(jax.jit(jax.grad(lambda p: JF.compute_loss(jm, p, *x, dropout_rng=key)[0]))(params)))
    model = PF.FusionMLP(hidden_dim=HIDDEN)
    weights.load_flax_tree(model, to_numpy(params))
    model.zero_grad()
    PF.compute_loss(model, *map(torch.from_numpy, x), dropout_rng=KEY)[0].backward()
    got = flat_tree(weights.flax_tree(model, lambda p: p.grad if p.grad is not None else torch.zeros_like(p)))
    scale = max(np.abs(g).max() for g in grads.values())
    assert sorted(got) == sorted(grads)
    for k, w in grads.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * scale, k


def test_checkpoints_cross_both_ways(pair, tmp_path):
    jm, params, pm = pair
    JF.save_checkpoint(str(tmp_path / "j.msgpack"), jm, params)
    model, w = PF.load_checkpoint(str(tmp_path / "j.msgpack"), device="cpu")
    same_tree(weights.flax_tree(model), to_numpy(params))
    assert model.dims() == PF.FusionMLP(hidden_dim=HIDDEN).dims() and w == JF.get_weights(jm, params)
    PF.save_checkpoint(str(tmp_path / "p.msgpack"), model)
    jm2, jparams, jw = JF.load_checkpoint(str(tmp_path / "p.msgpack"))
    same_tree(to_numpy(jparams), to_numpy(params))
    assert jm2 == jm and jw == PF.get_weights(model) and abs(sum(jw.values()) - 1.0) < 1e-6


def test_load_checkpoint_creates_if_missing(tmp_path):
    path = tmp_path / "new" / "fusion.msgpack"
    with pytest.raises(FileNotFoundError):
        PF.load_checkpoint(str(path), create_if_missing=False, device="cpu")
    made, w = PF.load_checkpoint(str(path), seed=5, device="cpu")
    assert path.exists() and made.dims() == PF.FusionMLP().dims()
    again, w2 = PF.load_checkpoint(str(path), device="cpu")
    same_tree(weights.flax_tree(again), weights.flax_tree(made))
    assert w == w2


# --- the trainer ---------------------------------------------------------------


def _write_dataset(root, n=24):
    """JAX's trainer tests' records (tests/test_checkpointing.py)."""
    rng = np.random.default_rng(0)
    recs = []
    for _ in range(n):
        t = rng.random(7)
        recs.append({"face_vec": rng.normal(size=27).tolist(), "audio_vec": rng.normal(size=31).tolist(),
                     "text_vec": rng.normal(size=783).tolist(), "target": (t / t.sum()).tolist()})
    for split, lo, hi in (("train", 0, 16), ("val", 16, 24)):
        d = root / "ami" / split
        d.mkdir(parents=True, exist_ok=True)
        (d / "data.json").write_text(json.dumps(recs[lo:hi]))
    return str(root / "ami")


# a learning rate at which the validation loss turns within a few epochs,
# so that patience 1 stops both packages early
TRAIN = dict(batch_size=8, learning_rate=1e-2, patience=1)
EPOCHS = 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    data = _write_dataset(root)
    mesh = mesh_lib.data_parallel_mesh(jax.devices()[:1])
    _, jh = JTF.train(data, str(root / "j"), num_epochs=EPOCHS, model=JF.FusionMLP(hidden_dim=HIDDEN), mesh=mesh, **TRAIN)
    net, ph = PTF.train(data, str(root / "p"), num_epochs=EPOCHS, model=PF.FusionMLP(hidden_dim=HIDDEN), device="cpu", **TRAIN)
    return root, data, mesh, jh, ph, net


def _close(got, want):
    for k in want:
        assert len(got[k]) == len(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0)


def test_train_follows_jax_and_stops_at_the_same_epoch(runs):
    root, _, _, jh, ph, net = runs
    assert 2 <= len(jh["train_loss"]) < EPOCHS  # stopped early
    _close(ph, jh)
    best, _ = PF.load_checkpoint(str(root / "p" / "best_model.msgpack"), device="cpu")
    jbest = PF.load_checkpoint(str(root / "j" / "best_model.msgpack"), device="cpu")[0]
    for (_, a), (_, b) in zip(sorted(weights.flax_tree(best).items()), sorted(weights.flax_tree(jbest).items())):
        for g, w in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def test_resume_crosses_both_packages(runs):
    """Each package resumes from the state the other wrote (the epoch
    before the early stop) and follows the other's own resume."""
    root, data, mesh, *_ = runs
    for src, dst in (("j", "jp"), ("j", "jj"), ("p", "pj"), ("p", "pp")):
        shutil.copytree(root / src, root / dst)
    more = dict(TRAIN, patience=3)
    _, jj = JTF.train(data, str(root / "jj"), num_epochs=EPOCHS, model=JF.FusionMLP(hidden_dim=HIDDEN), mesh=mesh, resume=True, **more)
    _, jp = PTF.train(data, str(root / "jp"), num_epochs=EPOCHS, model=PF.FusionMLP(hidden_dim=HIDDEN), device="cpu", resume=True, **more)
    _, pj = JTF.train(data, str(root / "pj"), num_epochs=EPOCHS, model=JF.FusionMLP(hidden_dim=HIDDEN), mesh=mesh, resume=True, **more)
    _, pp = PTF.train(data, str(root / "pp"), num_epochs=EPOCHS, model=PF.FusionMLP(hidden_dim=HIDDEN), device="cpu", resume=True, **more)
    assert jj["train_loss"]
    _close(jp, jj)
    _close(pp, pj)
