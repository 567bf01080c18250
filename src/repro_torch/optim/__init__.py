from repro_torch.optim.optimizers import (OptState, adam_init, adam_update,
                                          make_optimizer, sgd_init,
                                          sgd_update)
