"""msa_tpu_torch — the PyTorch/CUDA port of msa_tpu for one NVIDIA H100.

Layout mirrors ``msa_tpu`` so each module's counterpart is easy to find:

- ``core``        — emotion label maps and the config fields the graph reads
- ``checkpoints`` — a pure-Python reader for the flax-msgpack checkpoints
- ``weights``     — flax param trees → this package's modules
- ``ops``         — feature math (pad+LayerNorm, DSP, landmark geometry) and
                    ``ops.kernels``: the hand-written CUDA kernels that replace
                    the Pallas TPU kernels, each beside its plain version
- ``models``      — encoder, text, audio, face and fusion ``nn.Module``s
- ``pipeline``    — the batched segment graph (``SegmentPipeline.run_host``)

Entry points take ``device="cuda"`` by default; ``device="cpu"`` runs every
kernel's plain PyTorch version (the CPU tests use it). Nothing falls back to
the CPU when no GPU is found.
"""

__version__ = "0.1.0"

from msa_tpu_torch.core import config, emotions, schema  # noqa: F401,E402
