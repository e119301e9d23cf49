from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTStaticCache, load_paddle_tpu_state)
