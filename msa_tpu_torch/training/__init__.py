"""Training (port of ``msa_tpu/training/``): the fusion trainer
(:mod:`~msa_tpu_torch.training.train_fusion`, whose names JAX's package
exports), the AMI preprocessor (:mod:`~msa_tpu_torch.training.preprocess_ami`),
the encoders' training step (:mod:`~msa_tpu_torch.training.encoders`), and
the synthetic-supervision recipes: the generators
(:mod:`~msa_tpu_torch.training.face_synth`, ``text_synth``,
``speech_synth``, ``synth_av``) and the trainers of the landmark net, the
face emotion CNN, the audio emotion head, the text heads and the speaker
embedder (``train_landmarks``, ``train_face_emotion``,
``train_audio_emotion``, ``train_text_heads``, ``train_speaker``), each a
``python -m msa_tpu_torch.training.<name>`` CLI with JAX's flags."""

from msa_tpu_torch.training.encoders import (  # noqa: F401
    TEXT_HEADS,
    adamw,
    audio_loss,
    cross_entropy,
    text_loss,
    train_step,
)
from msa_tpu_torch.training.train_fusion import TrainState, make_train_step, train  # noqa: F401
