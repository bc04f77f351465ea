"""Speaker-embedder training CLI (port of ``msa_tpu/training/train_speaker.py``).

Trains :class:`msa_tpu_torch.models.speaker.SpeakerEmbeddingNet` with the
GE2E objective on procedurally synthesized voices (new identities every
step) on the card, and writes the checkpoint the neural diarizer loads
(``DiarizationConfig.speaker_weights``), flax's bytes.

Usage::

    python -m msa_tpu_torch.training.train_speaker --steps 1000 \
        --out checkpoints/speaker_embedder.msgpack
"""

from __future__ import annotations


def main(argv=None) -> int:
    """JAX's CLI, plus ``--device``."""
    import argparse

    from msa_tpu_torch.models.speaker import SpeakerConfig, save_params, train_speaker_embedder

    parser = argparse.ArgumentParser(description="Treina o speaker embedder")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--speakers", type=int, default=8, help="N por batch")
    parser.add_argument("--utts", type=int, default=4, help="M por speaker")
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="checkpoints/speaker_embedder.msgpack")
    parser.add_argument("--device", default="cuda", help="torch device to train on")
    args = parser.parse_args(argv)

    _, params, history = train_speaker_embedder(
        cfg=SpeakerConfig(),
        steps=args.steps,
        n_speakers=args.speakers,
        n_utts=args.utts,
        lr=args.lr,
        seed=args.seed,
        log_every=max(args.steps // 20, 1),
        device=args.device,
    )
    save_params(params, args.out)
    print(f"final ge2e_loss={history['loss'][-1]:.4f} → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
