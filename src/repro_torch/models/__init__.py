from repro_torch.models.model import (decode_step, init_caches, init_params,
                                      param_count, prefill, prefill_last)
