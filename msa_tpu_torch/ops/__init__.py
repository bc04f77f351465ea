from msa_tpu_torch.ops import normalization  # noqa: F401
