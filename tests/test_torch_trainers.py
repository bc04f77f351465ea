"""The port's synthetic-supervision trainers against the JAX package's, on
the CPU, at the tiny configs (``FaceModelConfig.tiny()``,
``SpeakerConfig.tiny()``, the ``EncoderConfig.tiny()`` trunks).

- ``ge2e_loss`` and its gradient (autograd against ``jax.grad``) within
  ``GE2E_RTOL`` of the largest value of each, f32 on both sides, summed in
  another order; the bias's gradient is 0 in exact arithmetic (it shifts
  every logit alike), so it is held at ``GE2E_ZERO_ATOL``;
- the pool trainer's minibatch indices (``flax_init.randint`` against
  ``jax.random.randint``) bit for bit, over spans that are and are not
  powers of two;
- each trainer's first three losses against JAX's (read from the same
  per-step log records on both sides) within ``LOSS_RTOL`` of JAX's: both
  start from the same params (the port's init trees, handed to both) or,
  for the speaker net, each package's own init of the seed (within a few
  f32 ulp of each other); optax's Adam/AdamW and torch's compute the same
  update in another order, and an Adam step scales each gradient to
  about ±lr however small it is, so a rounding difference in a near-zero
  gradient moves a weight by up to lr (PR 13's Adam hazard): 1e-3 of the
  loss after three such steps;
- the folded linear head of ``train_head`` within ``HEAD_RTOL`` of its
  largest value;
- every msgpack file the trainers write byte-equal to JAX's for the same
  tree, and each package's file loading in the other.

No run to convergence: JAX's own ``test_face_training.py`` and
``test_diarization.py`` hold learning.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models import audio as JA
from msa_tpu.models import face as JF
from msa_tpu.models import speaker as JS
from msa_tpu.models import text as JT
from msa_tpu.training import train_audio_emotion as JAE
from msa_tpu.training import train_face_emotion as JFE
from msa_tpu.training import train_landmarks as JTL
from msa_tpu.training import train_text_heads as JTH
from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.models import audio as PA
from msa_tpu_torch.models import face as PF
from msa_tpu_torch.models import speaker as PS
from msa_tpu_torch.models import text as PT
from msa_tpu_torch.models.transformer import AttentiveStatsPool
from msa_tpu_torch.training import train_audio_emotion as PAE
from msa_tpu_torch.training import train_face_emotion as PFE
from msa_tpu_torch.training import train_landmarks as PTL
from msa_tpu_torch.training import train_text_heads as PTH

from torch_parity import flat_tree, same_tree

GE2E_RTOL = 1e-5
GE2E_ZERO_ATOL = 1e-7
LOSS_RTOL = 1e-3
HEAD_RTOL = 1e-4


def step_losses(caplog, logger_name):
    """The loss of every per-step log record of ``logger_name`` (the
    record's second argument, at full precision)."""
    return [float(r.args[1]) for r in caplog.records if r.name == logger_name and "step" in r.msg]


def close(got, want, rtol=LOSS_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and len(want) > 0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def init_tree(module, seed):
    return weights.flax_tree(flax_init.init_module_(module, seed))


# --- the speaker net's loss and trainer ------------------------------------------------


def test_ge2e_loss_and_gradient():
    r = np.random.default_rng(0)
    e = r.standard_normal((4, 3, 16)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    w, b = np.float32(7.5), np.float32(-3.0)
    jl, jg = jax.value_and_grad(JS.ge2e_loss, argnums=(0, 1, 2))(jnp.asarray(e), jnp.asarray(w), jnp.asarray(b))
    pe, pw, pb = (torch.tensor(x, requires_grad=True) for x in (e, w, b))
    pl = PS.ge2e_loss(pe, pw, pb)
    pl.backward()
    close([float(pl.detach())], [float(jl)], GE2E_RTOL)
    for g, x in zip(jg[:2], (pe, pw)):
        g = np.asarray(g)
        assert float(np.abs(x.grad.numpy() - g).max()) <= GE2E_RTOL * float(np.abs(g).max())
    assert abs(float(pb.grad)) <= GE2E_ZERO_ATOL and abs(float(jg[2])) <= GE2E_ZERO_ATOL


def test_speaker_trainer_losses_and_files(tmp_path):
    cfg = JS.SpeakerConfig.tiny()
    kw = dict(steps=3, n_speakers=3, n_utts=2, lr=2e-3, seed=0)
    _, jparams, jh = JS.train_speaker_embedder(cfg=cfg, **kw)
    pnet, pparams, ph = PS.train_speaker_embedder(cfg=PS.SpeakerConfig.tiny(), device="cpu", **kw)
    close(ph["loss"], jh["loss"])
    # the files: the same tree gives the same bytes, each loads in the other
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    JS.save_params(tree, str(tmp_path / "jax.msgpack"))
    PS.save_params(tree, str(tmp_path / "port.msgpack"))
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    PS.save_params(weights.flax_tree(pnet), str(tmp_path / "net.msgpack"))
    back = JS.load_params(JS.SpeakerEmbeddingNet(cfg), str(tmp_path / "net.msgpack"))
    same_tree(jax.tree_util.tree_map(np.asarray, back), pparams)
    loaded = PS.load_params(PS.SpeakerEmbeddingNet(PS.SpeakerConfig.tiny()), str(tmp_path / "jax.msgpack"))
    same_tree(weights.flax_tree(loaded), tree)


# --- the pool trainer's minibatch indices ---------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100, 1000, 65536, 65537, 123457])
def test_randint_is_jax_randint(n):
    key, k = jax.random.PRNGKey(3), flax_init.prng_key(3)
    for _ in range(3):
        key, sub = jax.random.split(key)
        k, s = flax_init.split(k)
        want = np.asarray(jax.random.randint(sub, (64,), 0, n))
        got = flax_init.randint(s, 64, 0, n).numpy()
        assert np.array_equal(got, want)


# --- the face trainers ------------------------------------------------------------------


def test_landmark_trainer_first_losses(caplog):
    caplog.set_level(logging.INFO)
    tree = init_tree(PF.FaceLandmarkNet(PF.FaceModelConfig.tiny()), 0)
    kw = dict(steps=3, batch=4, lr=3e-3, seed=0, params=tree, log_every=1, expressions=True)
    jp, jm = JTL.train(JF.FaceModelConfig.tiny(), **kw)
    pp, pm = PTL.train(PF.FaceModelConfig.tiny(), device="cpu", **kw)
    close(step_losses(caplog, PTL.logger.name), step_losses(caplog, JTL.logger.name))
    assert sorted(pm) == sorted(jm)
    flat_j, flat_p = flat_tree(jax.tree_util.tree_map(np.asarray, jp)), flat_tree(pp)
    assert sorted(flat_j) == sorted(flat_p)


def test_face_emotion_trainer_first_losses_and_file(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    tree = init_tree(PF.FaceEmotionCNN(PF.FaceModelConfig.tiny()), 0)
    kw = dict(steps=3, batch=8, lr=1e-3, seed=0, params=tree, log_every=1, frame_size=64)
    jp, jm = JFE.train(JF.FaceModelConfig.tiny(), **kw)
    pp, pm = PFE.train(PF.FaceModelConfig.tiny(), device="cpu", **kw)
    close(step_losses(caplog, PFE.logger.name), step_losses(caplog, JFE.logger.name))
    assert sorted(pm) == sorted(jm)
    jtree = jax.tree_util.tree_map(np.asarray, jp)
    JFE.save_params(jtree, str(tmp_path / "jax.msgpack"))
    PFE.save_params(jtree, str(tmp_path / "port.msgpack"))
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    PFE.save_params(pp, str(tmp_path / "trained.msgpack"))
    from flax import serialization

    same_tree(serialization.msgpack_restore((tmp_path / "trained.msgpack").read_bytes()), pp)


# --- the audio emotion head -------------------------------------------------------------


@pytest.fixture(scope="module")
def audio_trunk():
    """The tiny audio trunk on both sides with the same params."""
    pm = flax_init.init_module_(PA.AudioEmotionModel(PA.AudioModelConfig.tiny()), 2).eval()
    return JA.AudioEmotionModel(JA.AudioModelConfig.tiny()), pm, weights.flax_tree(pm)


AUDIO_RUN = dict(n_train=6, n_eval=5, steps=3, seed=0, batch=4, seconds=1.0, samples=16_000, log_every=1)


@pytest.mark.parametrize("mode", ["pool", "head"])
def test_audio_emotion_trainer_first_losses(caplog, audio_trunk, mode):
    caplog.set_level(logging.INFO)
    jmodel, pmodel, tree = audio_trunk
    jh, jm = JAE.train(jmodel, tree, mode=mode, speech_fraction=0.5, **AUDIO_RUN)
    ph, pm = PAE.train(pmodel, None, mode=mode, speech_fraction=0.5, device="cpu", **AUDIO_RUN)
    close(step_losses(caplog, PAE.logger.name), step_losses(caplog, JAE.logger.name))
    assert list(flat_tree(ph)) == list(flat_tree(jh))
    assert sorted(pm) == sorted(jm)


def test_train_head_folds_the_standardization():
    r = np.random.default_rng(5)
    feats = (3.0 + 2.0 * r.standard_normal((40, 24))).astype(np.float32)
    labels = r.integers(0, 4, 40).astype(np.int64)
    head0 = {"kernel": (0.1 * r.standard_normal((24, 4))).astype(np.float32), "bias": np.zeros(4, np.float32)}
    want = JAE.train_head(feats, labels, head0, steps=5, batch=16, seed=1)
    got = PAE.train_head(feats, labels, head0, steps=5, batch=16, seed=1, device="cpu")
    assert list(got) == ["kernel", "bias"]
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert float(np.abs(got[k] - want[k]).max()) <= HEAD_RTOL * float(np.abs(want[k]).max())


def test_pool_head_indices_and_file(tmp_path, audio_trunk):
    """train_pool_head at steps=0 returns its init as JAX's does (sorted
    keys), and the asset files of both recipes are JAX's bytes."""
    _, pmodel, tree = audio_trunk
    hidden = np.random.default_rng(6).standard_normal((5, 7, 32)).astype(np.float16)
    init = {"pool": tree["pool"], "emotion_head": tree["emotion_head"]}
    want = JAE.train_pool_head(hidden, np.arange(5) % 4, JA.AttentiveStatsPool(8), init, steps=0)
    got = PAE.train_pool_head(hidden, np.arange(5) % 4, AttentiveStatsPool(32, 8), init, steps=0)
    same_tree(got, jax.tree_util.tree_map(np.asarray, want))
    assert list(flat_tree(got)) == list(flat_tree(want))
    linear = {"kernel": tree["emotion_head"]["kernel"], "bias": tree["emotion_head"]["bias"]}
    for name, head in (("pool", got), ("linear", linear)):
        JAE.save_head(head, str(tmp_path / f"{name}_jax.msgpack"))
        PAE.save_head(head, str(tmp_path / f"{name}_port.msgpack"))
        assert (tmp_path / f"{name}_jax.msgpack").read_bytes() == (tmp_path / f"{name}_port.msgpack").read_bytes()
        same_tree(PAE.load_head(str(tmp_path / f"{name}_jax.msgpack")), head)
        same_tree(JAE.load_head(str(tmp_path / f"{name}_port.msgpack")), head)


# --- the text heads ---------------------------------------------------------------------


def test_text_heads_trainer_first_losses_and_file(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    pmodel = flax_init.init_module_(PT.TextModel(PT.TextModelConfig.tiny()), 3).eval()
    tree = weights.flax_tree(pmodel)
    kw = dict(n_train=24, steps=3, seed=0, log_every=1)
    jh, jm = JTH.train(JT.TextModel(JT.TextModelConfig.tiny()), tree, JT.WordPieceTokenizer(vocab_size=128), **kw)
    ph, pm = PTH.train(pmodel, None, PT.WordPieceTokenizer(vocab_size=128), device="cpu", **kw)
    want = step_losses(caplog, JAE.logger.name)
    assert len(want) == 4 * 3  # four heads, three steps each
    close(step_losses(caplog, PAE.logger.name), want)
    assert list(ph) == list(jh) == [name for name, _, _ in PTH.TASKS]
    assert sorted(pm) == sorted(jm)
    jtree = jax.tree_util.tree_map(np.asarray, jh)
    JTH.save_heads(jtree, str(tmp_path / "jax.msgpack"))
    PTH.save_heads(jtree, str(tmp_path / "port.msgpack"))
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    PTH.save_heads(ph, str(tmp_path / "trained.msgpack"))
    same_tree(jax.tree_util.tree_map(np.asarray, JTH.load_heads(str(tmp_path / "trained.msgpack"))), ph)


# --- the command lines ------------------------------------------------------------------


CLIS = ("train_landmarks", "train_face_emotion", "train_audio_emotion", "train_text_heads", "train_speaker", "synth_av")


@pytest.mark.parametrize("name", CLIS)
def test_cli_flags_are_jax_flags(name, capsys):
    """Each CLI takes JAX's flags (the trainers ``--device`` besides)."""
    import importlib
    import re

    flags = {}
    for pkg in ("msa_tpu", "msa_tpu_torch"):
        with pytest.raises(SystemExit) as e:
            importlib.import_module(f"{pkg}.training.{name}").main(["--help"])
        assert e.value.code == 0
        flags[pkg] = set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out)) - {"--help"}
    extra = set() if name == "synth_av" else {"--device"}
    assert flags["msa_tpu"] and flags["msa_tpu_torch"] == flags["msa_tpu"] | extra


def test_speaker_cli_writes_a_loadable_checkpoint(tmp_path):
    from msa_tpu_torch.training import train_speaker

    out = tmp_path / "speaker_embedder.msgpack"
    assert train_speaker.main(["--steps", "1", "--speakers", "2", "--utts", "2", "--device", "cpu", "--out", str(out)]) == 0
    JS.load_params(JS.SpeakerEmbeddingNet(JS.SpeakerConfig()), str(out))
