from msa_tpu_torch.models.fusion import FusionMLP, FusionModel  # noqa: F401
