"""The msgpack writer and the whole-pipeline checkpoint against the JAX
package on the CPU.

- ``flax_msgpack.dumps`` rewrites every shipped ``msa_tpu/checkpoints/*.msgpack``
  (read by path) to the file's own bytes, and gives
  ``flax.serialization.msgpack_serialize``'s bytes on random trees, sorted
  and in place, the chunked form included (``MAX_CHUNK_SIZE`` made small on
  both sides);
- a file JAX's ``save_pipeline`` writes loads in the port with every leaf
  bit-equal, and one the port writes loads through JAX's ``load_pipeline``
  the same; the meta is JAX's schema (``"kernel"`` ↔ ``"pallas"``), and the
  port's rewrite of JAX's file is JAX's file byte for byte;
- the port's params tree has JAX's init's names, shapes and dtypes;
- create-if-missing;
- ``run_host`` through the models the port loaded is within 1e-3 of JAX's
  on the plain f32 path.

The JAX side is built from the port's tiny models (JAX's own classes and
functions, the port's numbers), so no JAX init runs; ``jax.eval_shape`` of
JAX's init gives the tree it would draw.
"""

import copy
import dataclasses
import json
import pathlib

import flax.core
import flax.serialization
import jax
import numpy as np
import pytest

from msa_tpu.models import audio as JA
from msa_tpu.models import face as JFace
from msa_tpu.models import fusion as JF
from msa_tpu.models import text as JT
from msa_tpu.pipeline import checkpoint as JC
from msa_tpu.pipeline import graph as JG
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.pipeline import checkpoint as PC
from msa_tpu_torch.pipeline import graph as PG
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.text import TextModelConfig
from torch_parity import flat_tree, jax_tiny_models, same_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHIPPED = sorted((ROOT / "msa_tpu" / "checkpoints").glob("*.msgpack"))
SAMPLES, TOKENS = 4000, 16


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.name)
def test_writer_rewrites_shipped_files_to_their_bytes(path):
    data = path.read_bytes()
    tree = flax_msgpack.loads(data)
    assert flax_msgpack.dumps(tree, sort_keys=False) == data
    assert flax_msgpack.dumps(tree) == flax.serialization.msgpack_serialize(flax.serialization.msgpack_restore(data))


def _random_tree(rng, depth=0):
    leaves = [
        lambda: rng.normal(size=tuple(rng.integers(0, 5, size=rng.integers(0, 4)))).astype(rng.choice(["float32", "float64", "float16"])),
        lambda: rng.integers(-(2**40), 2**40, size=rng.integers(1, 300)).astype(rng.choice(["int8", "int32", "int64", "uint16"])),
        lambda: int(rng.choice([0, 5, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128, -129, -(2**31) - 1])),
        lambda: float(rng.normal()),
        lambda: "é" * int(rng.choice([0, 31, 32, 255, 300])),
        lambda: np.float32(rng.normal()),
        lambda: np.int64(rng.integers(-9, 9)),
        lambda: complex(rng.normal(), rng.normal()),
        lambda: bytes(rng.integers(0, 256, size=rng.integers(0, 40)).astype(np.uint8)),
        lambda: [None, True, False, int(rng.integers(0, 9)), [1.5, "x"]],
        lambda: rng.normal(size=(70, 3)).astype(np.float32),  # past the small chunk limit
    ]
    n = int(rng.integers(1, 18))
    keys = [f"k{int(k)}" for k in rng.permutation(40)[:n]]
    return {k: (_random_tree(rng, depth + 1) if depth < 2 and rng.random() < 0.25 else leaves[int(rng.integers(len(leaves)))]())
            for k in keys}


@pytest.mark.parametrize("seed", range(6))
def test_writer_matches_flax_on_random_trees(seed, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 256)
    tree = _random_tree(np.random.default_rng(seed))
    want = flax.serialization.msgpack_serialize(tree)
    assert flax_msgpack.dumps(tree) == want
    assert flax_msgpack.dumps(tree, sort_keys=False) == flax.serialization.msgpack_serialize(tree, in_place=True)
    assert b"__msgpack_chunked_array__" in want  # the chunked form was exercised
    assert flax_msgpack.dumps(flax_msgpack.loads(want)) == want  # read back whole, chunks joined


# --- the pipeline checkpoint --------------------------------------------------


@pytest.fixture(scope="module")
def port_tiny():
    return PG.PipelineModels.tiny(seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_file(port_tiny, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "pipe.msgpack"
    JC.save_pipeline(str(path), jax_tiny_models(port_tiny))
    return path


def test_params_tree_has_jax_init_shapes(port_tiny):
    m = jax_tiny_models(port_tiny)
    want = {
        "landmark": jax.eval_shape(lambda: JFace._init_landmark_host(m.landmark, 0)),
        "face_cnn": jax.eval_shape(lambda: JFace._init_emotion_host(m.face_cnn, 1)),
        "audio": jax.eval_shape(lambda: JA._init_host(m.audio, 2, 8000)),
        "text": jax.eval_shape(lambda: JT._init_host(m.text, 3)),
        "fusion": jax.eval_shape(lambda: JF._init_host(m.fusion, 0)),
    }

    def shapes(tree):
        leaves = jax.tree_util.tree_leaves_with_path(flax.core.unfreeze(tree))
        return {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype)) for p, v in leaves}

    assert shapes(port_tiny.params_tree()) == shapes(want)


def test_jax_file_loads_in_the_port(port_tiny, jax_file, tmp_path):
    models = PC.load_pipeline(str(jax_file), device="cpu")
    same_tree(models.params_tree(), port_tiny.params_tree())
    meta = json.loads(flax_msgpack.load(jax_file)["meta_json"])
    assert meta["text"]["encoder"] == dataclasses.asdict(JT.TextModelConfig.tiny().encoder)
    assert models.text.cfg == port_tiny.text.cfg and models.audio.cfg == port_tiny.audio.cfg
    assert models.landmark.cfg == port_tiny.landmark.cfg and models.fusion.dims() == port_tiny.fusion.dims()
    # the params_tree() orders differ (module order against flax's), but both
    # writers sort the keys as msgpack_serialize does: the rewrite is JAX's file
    PC.save_pipeline(str(tmp_path / "p.msgpack"), models)
    assert (tmp_path / "p.msgpack").read_bytes() == jax_file.read_bytes()


def test_port_file_loads_through_jax(port_tiny, tmp_path, monkeypatch):
    import torch

    src = copy.deepcopy(port_tiny)
    with torch.no_grad():  # every leaf off the template's (the bias leaves the init leaves at zero too)
        for module in src.modules():
            for p in module.parameters():
                p.add_(0.25)
    path = tmp_path / "port.msgpack"
    PC.save_pipeline(str(path), src)
    # JAX's load_pipeline rebuilds through initialize for a template only
    template = jax_tiny_models(port_tiny)
    monkeypatch.setattr(JG.PipelineModels, "initialize", classmethod(lambda cls, **kw: template))
    restored = JC.load_pipeline(str(path))
    same_tree(jax.tree_util.tree_map(np.asarray, restored.params_tree()), src.params_tree())
    kernel = PG.PipelineModels.serving_encoder("int8")
    models = PG.PipelineModels._build(port_tiny.landmark.cfg, dataclasses.replace(port_tiny.audio.cfg, encoder=kernel),
                                      port_tiny.text.cfg, port_tiny.fusion.dims(), "cpu")
    PC.save_pipeline(str(tmp_path / "k.msgpack"), models)
    enc = json.loads(flax_msgpack.load(tmp_path / "k.msgpack")["meta_json"])["audio"]["encoder"]
    assert list(enc) == [f.name for f in dataclasses.fields(JA.AudioModelConfig().encoder)]
    assert (enc["attention_impl"], enc["ffn_impl"], enc["quantize"]) == ("pallas", "pallas", "int8")
    assert PC.load_pipeline(str(tmp_path / "k.msgpack"), device="cpu").audio.cfg.encoder == kernel


def test_create_if_missing(tmp_path, monkeypatch):
    orig = PG.PipelineModels.initialize.__func__
    monkeypatch.setattr(
        PG.PipelineModels, "initialize",
        classmethod(lambda cls, seed=0, device="cuda": orig(
            cls, seed, face_cfg=FaceModelConfig.tiny(), audio_cfg=AudioModelConfig.tiny(),
            text_cfg=TextModelConfig.tiny(), fusion={"hidden_dim": 64}, device=device)),
    )
    path = tmp_path / "missing" / "pipe.msgpack"
    with pytest.raises(FileNotFoundError):
        PC.load_pipeline(str(path), create_if_missing=False, device="cpu")
    made = PC.load_pipeline(str(path), seed=2, device="cpu")
    assert path.exists() and made.fusion.output_dim == 7
    same_tree(PC.load_pipeline(str(path), device="cpu").params_tree(), made.params_tree())


def test_run_host_through_loaded_models_matches_jax(port_tiny, jax_file):
    models = PC.load_pipeline(str(jax_file), device="cpu")
    jm = jax_tiny_models(port_tiny)
    rng = np.random.default_rng(0)
    inp = JG.SegmentInputs.zeros(jm, 2, samples=SAMPLES, tokens=TOKENS)
    inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
    inp.audio = (0.1 * rng.standard_normal(inp.audio.shape)).astype(np.float32)
    inp.token_ids = rng.integers(1, 128, size=inp.token_ids.shape).astype(np.int32)
    inp.token_mask = np.ones_like(inp.token_mask)
    want = np.asarray(JG.SegmentPipeline(jm).run_host(inp)[0]["hostpack"])
    port_inp = PG.SegmentInputs(**{f.name: getattr(inp, f.name) for f in dataclasses.fields(PG.SegmentInputs)})
    got = PG.SegmentPipeline(models).run_host(port_inp)[0]["hostpack"].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3
