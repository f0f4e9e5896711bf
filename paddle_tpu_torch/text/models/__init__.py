from .bert import (Bert, BertConfig,  # noqa: F401
                   BertPretrainingCriterion)
from .gpt import GPT, GPTConfig  # noqa: F401
