from .pipeline import PipelineState, SyntheticPipeline

__all__ = ["SyntheticPipeline", "PipelineState"]
