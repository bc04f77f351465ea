from msa_tpu_torch.pipeline.graph import (  # noqa: F401
    PipelineModels,
    SegmentInputs,
    SegmentPipeline,
)
