"""The port's pure-Python flax-msgpack reader against flax itself, and the
shipped checkpoints loaded into the port's full-size modules."""

import glob
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models import face as PFace
from msa_tpu_torch.models.fusion import FusionMLP
from msa_tpu_torch.models.transformer import AttentiveStatsPool

CKPT = os.path.join(os.path.dirname(__file__), "..", "msa_tpu", "checkpoints")
SHIPPED = sorted(
    os.path.relpath(p, CKPT) for p in glob.glob(os.path.join(CKPT, "**", "*.msgpack"), recursive=True)
)


def _count(tree):
    return sum(_count(v) if isinstance(v, dict) else int(np.size(v)) for v in tree.values())


def _assert_bit_equal(got, want):
    lg = jax.tree_util.tree_flatten_with_path(got)[0]
    lw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lg, lw):
        if isinstance(w, (np.ndarray, np.generic)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path
        else:
            assert type(g) is type(w) and g == w, path


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_checkpoint_leaves_bit_equal_to_flax(name):
    raw = open(os.path.join(CKPT, name), "rb").read()
    _assert_bit_equal(flax_msgpack.loads(raw), flax.serialization.msgpack_restore(raw))


def test_reader_covers_flax_ext_types_and_chunks(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "i8": np.arange(-5, 5, dtype=np.int8),
        "u64": np.array([2**40], np.uint64),
        "f64_scalar": np.float64(1.5),
        "complex": complex(1.0, -2.0),
        "nested": {"neg": -7, "big": 2**40, "text": "é" * 40, "flag": True, "none": None, "x": 0.25},
        "list": [1, -200, 70000, -70000, 3.5],
        "empty": np.zeros((0, 5), np.float16),
    }
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)  # forces chunked arrays
    raw = flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(raw)
    _assert_bit_equal(flax_msgpack.loads(raw), want)


def test_reader_widens_bfloat16_exactly():
    import jax.numpy as jnp

    x = jnp.asarray(np.linspace(-3, 3, 11, dtype=np.float32)).astype(jnp.bfloat16)
    raw = flax.serialization.msgpack_serialize({"x": x})
    got = flax_msgpack.loads(raw)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x.astype(jnp.float32)))


def test_shipped_checkpoints_load_into_full_size_modules():
    cfg = PFace.FaceModelConfig()
    for module, name in (
        (PFace.FaceLandmarkNet(cfg), "landmark_net.msgpack"),
        (PFace.FaceEmotionCNN(cfg), "face_emotion_cnn.msgpack"),
    ):
        tree = flax_msgpack.load(os.path.join(CKPT, name))
        weights.load_flax_tree(module, tree)
        assert sum(p.numel() for p in module.parameters()) == _count(tree)
    fusion = FusionMLP()
    payload = flax_msgpack.load(os.path.join(CKPT, "fusion.msgpack"))
    weights.load_flax_tree(fusion, payload["params"])
    head = flax_msgpack.load(os.path.join(CKPT, "audio_emotion_head.msgpack"))
    pool = AttentiveStatsPool(768, 128)
    weights.load_flax_tree(pool, head["pool"])
    k = head["pool"]["attn_hidden"]["kernel"]
    np.testing.assert_array_equal(pool.attn_hidden.weight.detach().numpy(), k.T)


def test_loader_rejects_mismatched_trees():
    net = PFace.FaceEmotionCNN(PFace.FaceModelConfig(cnn_channels=(4, 8)))
    tree = flax_msgpack.load(os.path.join(CKPT, "face_emotion_cnn.msgpack"))
    with pytest.raises(ValueError):
        weights.load_flax_tree(net, tree)
    with pytest.raises(KeyError):
        weights.load_flax_tree(net, {"no_such_layer": {"bias": np.zeros(3)}})


def test_random_draw_is_seeded_and_scaled():
    """The rebuilt flax init (lecun_normal: truncated at ±2σ, σ = 1/√fan_in
    over 0.8796) is a function of the seed alone."""
    a, b = torch.nn.Linear(256, 64), torch.nn.Linear(256, 64)
    flax_init.init_module_(a, 5)
    flax_init.init_module_(b, 5)
    torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
    assert not a.bias.any()
    assert a.weight.abs().max() <= 2 / 16 / 0.8796 + 1e-6  # truncated at 2σ, σ = 1/√fan_in/0.88
    assert abs(float(a.weight.detach().std()) - 1 / 16) < 0.01
