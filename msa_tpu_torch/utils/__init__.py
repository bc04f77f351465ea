from msa_tpu_torch.utils.logging_config import setup_logging  # noqa: F401
from msa_tpu_torch.utils.misc import create_directories  # noqa: F401
