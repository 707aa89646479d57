"""Model code of the port (counterpart of ``paddle_tpu/models``), with the
reference's re-exports."""

from . import bert, llama  # noqa: F401
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel)
from .llama import (LlamaConfig, LlamaForCausalLM, forward,  # noqa: F401
                    init_params, loss_fn, param_specs)
