from repro_torch.models.model import (cross_entropy, decode_step, init_caches,
                                      init_params, loss_fn, param_count,
                                      prefill, prefill_last)
