from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .mp_ops import c_concat, c_identity, c_split, mp_allreduce
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "c_identity", "c_concat", "c_split",
           "mp_allreduce"]
