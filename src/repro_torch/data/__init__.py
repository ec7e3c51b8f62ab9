from repro_torch.data.pipeline import (DataConfig, eval_loss, make_batch_for,
                                       make_lm_batch, sample_tokens)

__all__ = ["DataConfig", "eval_loss", "make_batch_for", "make_lm_batch",
           "sample_tokens"]
