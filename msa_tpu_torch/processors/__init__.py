from msa_tpu_torch.processors.offline import OfflineProcessor  # noqa: F401
from msa_tpu_torch.processors.streaming import StreamingProcessor  # noqa: F401
