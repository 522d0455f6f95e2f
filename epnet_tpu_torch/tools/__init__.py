"""Command-line entry points, run as ``python -m epnet_tpu_torch.tools.<name>``."""

import contextlib
import logging


@contextlib.contextmanager
def cli_logger(name: str, log_file: str):
    """The logger ``name`` writing to the console and to ``log_file`` for
    one CLI run; its handlers close when the run ends."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    for h in (logging.StreamHandler(), logging.FileHandler(log_file)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        yield logger
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
