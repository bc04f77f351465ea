from msa_tpu_torch.core import config, emotions, schema  # noqa: F401
