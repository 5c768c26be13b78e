"""The port's logger, "masr_tpu_torch": one stream handler on stderr,
configured once (the level from MASR_TPU_LOG_LEVEL, INFO by default)."""
import logging
import os


def setup_logger(name="masr_tpu_torch"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s %(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("MASR_TPU_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger
