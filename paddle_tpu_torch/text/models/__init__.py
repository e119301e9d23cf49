from .bert import (BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel,
                   ErnieForPretraining, ErnieForSequenceClassification,
                   ErnieModel, ernie_1_0, load_bert_state)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTStaticCache, load_paddle_tpu_state)
