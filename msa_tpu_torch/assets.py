"""Where the shipped checkpoints are. They are data files of the JAX
package and are read by path: config defaults are ``checkpoints/<name>``,
relative to ``msa_tpu/``, and a file at that path under the working
directory wins."""

from __future__ import annotations

from pathlib import Path

ASSET_ROOT = Path(__file__).resolve().parents[1] / "msa_tpu"


def resolve_asset(rel: str) -> Path:
    """``rel`` under the working directory, else under ``msa_tpu/``.
    Raises FileNotFoundError when neither exists."""
    for cand in (Path(rel), ASSET_ROOT / rel):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"shipped asset {rel} not found (looked in . and {ASSET_ROOT})")
