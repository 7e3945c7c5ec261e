from repro_torch.optim.optimizer import (adafactor_init, adafactor_update,  # noqa: F401
                                         adamw_init, adamw_update, global_norm)


def opt_init(cfg, params):
    if cfg.opt == "adafactor":
        return adafactor_init(params, cfg.opt_state_dtype)
    return adamw_init(params, cfg.opt_state_dtype)


def opt_update(cfg, params, grads, opt):
    if cfg.opt == "adafactor":
        return adafactor_update(params, grads, opt)
    return adamw_update(params, grads, opt)
