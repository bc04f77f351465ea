from msa_tpu_torch.visualizers.overlay import StreamingVisualizer  # noqa: F401
