"""The program's configuration as a configuration file states it."""

import dataclasses


def config(model: dict):
    """The program's GAPartNetConfig from a configuration file's `model`
    block (lists become the config's tuples)."""
    from gapartnet_tpu_torch.config import GAPartNetConfig

    fields = {f.name for f in dataclasses.fields(GAPartNetConfig)}
    return GAPartNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in model.items() if k in fields})
