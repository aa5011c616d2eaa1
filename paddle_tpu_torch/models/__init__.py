"""Models of the port (counterpart of paddle_tpu/models)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, ErnieModel)
from .convert import load_paddle_tpu_state, paddle_tpu_state
from .gpt import GPTConfig, GPTForCausalLM

__all__ = ["GPTConfig", "GPTForCausalLM", "BertConfig", "BertModel",
           "ErnieModel", "BertForSequenceClassification",
           "BertForPretraining", "load_paddle_tpu_state", "paddle_tpu_state"]
