from msa_tpu_torch.evaluation.evaluator import ModelEvaluator  # noqa: F401
