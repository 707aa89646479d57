"""``fleet.meta_parallel`` — the reference's namespace of parallel layers
(the mpu layers, ``PipelineLayer``, ``LayerDesc``, ``SharedLayerDesc``,
``PipelineParallel``)."""

from .layers.mpu import (ColumnParallelLinear, ParallelCrossEntropy,
                         RowParallelLinear, VocabParallelEmbedding,
                         get_rng_state_tracker, model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "get_rng_state_tracker",
           "model_parallel_random_seed", "PipelineLayer", "LayerDesc",
           "SharedLayerDesc", "PipelineParallel"]


def __getattr__(name):
    if name in ("PipelineLayer", "LayerDesc", "SharedLayerDesc",
                "PipelineParallel"):
        from .. import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
