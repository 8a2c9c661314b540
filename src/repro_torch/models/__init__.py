"""Model definitions of the port: the decoder-only stack (attention and
recurrent mixers, stub frontends) and the encoder-decoder."""

from .config import ModelConfig
from .model_api import (build_model, make_loss_fn, make_prefill_fn,
                        make_serve_step, make_train_step, reduce_grads)

__all__ = ["ModelConfig", "build_model", "make_loss_fn", "make_prefill_fn",
           "make_serve_step", "make_train_step", "reduce_grads"]
