"""Configs (port of masr_tpu/utils/config.py): a nested dict with
attribute access. `load_config` reads YAML and imports PyYAML only then,
so a dict config needs no YAML package."""
import os


class AttrDict(dict):
    """dict with attribute access, recursively applied by dict_to_object."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value


def dict_to_object(d):
    if isinstance(d, dict):
        return AttrDict({k: dict_to_object(v) for k, v in d.items()})
    if isinstance(d, (list, tuple)):
        return type(d)(dict_to_object(v) for v in d)
    return d


def load_config(path):
    """YAML file → nested AttrDict."""
    import yaml
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path, "r", encoding="utf-8") as f:
        return dict_to_object(yaml.safe_load(f))
