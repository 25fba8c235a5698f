from repro_torch.train.steps import (make_online_wave, make_train_state,
                                     make_train_step, merge_params,
                                     split_params)

__all__ = ["make_online_wave", "make_train_state", "make_train_step",
           "merge_params", "split_params"]
