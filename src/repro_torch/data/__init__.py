from repro_torch.data.pipeline import TokenPipeline, synthetic_stream  # noqa: F401
