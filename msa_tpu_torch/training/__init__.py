"""Training (port of ``msa_tpu/training/``): the fusion trainer
(:mod:`~msa_tpu_torch.training.train_fusion`, whose names JAX's package
exports), the AMI preprocessor (:mod:`~msa_tpu_torch.training.preprocess_ami`)
and the encoders' training step (:mod:`~msa_tpu_torch.training.encoders`)."""

from msa_tpu_torch.training.encoders import (  # noqa: F401
    TEXT_HEADS,
    adamw,
    audio_loss,
    cross_entropy,
    text_loss,
    train_step,
)
from msa_tpu_torch.training.train_fusion import TrainState, make_train_step, train  # noqa: F401
