"""Configs (port of masr_tpu/utils/config.py): a nested dict with
attribute access. `load_config` reads YAML and imports PyYAML only then,
so a dict config needs no YAML package; the CLIs' argument helpers."""
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


def strtobool(v):
    """'1' / 'true' / 'yes' / 'y' / 'on' → True, their opposites → False
    (the rule of distutils' strtobool, which Python 3.12 no longer has)."""
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "y", "on", "t"):
        return True
    if s in ("0", "false", "no", "n", "off", "f"):
        return False
    raise ValueError(f"not a truth value: {v!r}")


def add_arguments(argname, type, default, help, argparser, **kwargs):
    """One `--argname` option, the repository CLIs' convention (a bool
    option takes a truth value)."""
    argparser.add_argument("--" + argname, default=default,
                           type=strtobool if type == bool else type,
                           help=help + " 默认: %(default)s.", **kwargs)


def print_arguments(args):
    """Log the parsed arguments, sorted, as the repository CLIs do."""
    from masr_tpu_torch.utils.logger import setup_logger
    logger = setup_logger()
    logger.info("----------- 额外配置参数 -----------")
    for arg, value in sorted(vars(args).items()):
        logger.info(f"{arg}: {value}")
    logger.info("------------------------------------------------")
