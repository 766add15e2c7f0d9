"""Config system: YAML -> attribute-dict with `_BASE_CONFIG_` inheritance.

The port's own copy of findnpropagate_tpu/config.py (pure Python; the JAX
package's __init__ imports jax, so the port cannot import it from there).

Mirrors the reference's config surface (OpenPCDet's
pcdet/config.py:16-85): a global `cfg`, `cfg_from_yaml_file`, `cfg_from_list`
(CLI `--set KEY.SUBKEY value` overrides) and recursive `merge_new_config`
with `_BASE_CONFIG_` file inheritance — re-implemented without the easydict
dependency and with no global mutation requirement (the global `cfg` exists
for CLI convenience only; library code passes configs explicitly).
"""

from __future__ import annotations

import ast
from pathlib import Path

import yaml


class EDict(dict):
    """dict with attribute access; recursively wraps nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return EDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def copy(self):
        return EDict({k: (v.copy() if isinstance(v, EDict) else v) for k, v in self.items()})


def log_config_to_file(cfg_dict, pre="cfg", logger=None):
    emit = logger.info if logger is not None else print
    for key, val in cfg_dict.items():
        if isinstance(val, EDict):
            emit(f"----------- {key} -----------")
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
            continue
        emit(f"{pre}.{key}: {val}")


def merge_new_config(config, new_config):
    """Recursive merge; `_BASE_CONFIG_` in new_config pulls in a base YAML first."""
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"], "r") as f:
            yaml_config = yaml.safe_load(f)
        config.update(EDict(yaml_config))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), dict):
                config[key] = EDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config=None):
    if config is None:
        config = EDict()
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    # Experiment identity mirrors the reference (tools/train.py:102-103):
    # cfg filename -> TAG, parent dirs below tools/cfgs -> EXP_GROUP_PATH.
    p = Path(cfg_file)
    config.TAG = p.stem
    parts = list(p.resolve().parts)
    config.EXP_GROUP_PATH = parts[parts.index("cfgs") + 1] if "cfgs" in parts else p.parent.name
    return config


def _parse_value(v):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def cfg_from_list(cfg_list, config):
    """Set config keys via list, e.g. ['MODEL.NAME', 'PointPillar']."""
    assert len(cfg_list) % 2 == 0, "override list must be KEY VALUE pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                d[subkey] = EDict()
            d = d[subkey]
        subkey = key_list[-1]
        value = _parse_value(v)
        if subkey in d and isinstance(d[subkey], (list, tuple)) and not isinstance(value, (list, tuple)):
            # match reference semantics: allow comma lists for list-typed keys
            value = [_parse_value(x) for x in str(v).split(",")]
        d[subkey] = value
    return config


cfg = EDict()
cfg.LOCAL_RANK = 0
