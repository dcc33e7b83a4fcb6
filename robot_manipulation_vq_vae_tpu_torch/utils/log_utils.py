"""Logging: stdout tee, tensorboard/wandb fan-out, warning buffer (a copy of
the JAX package's ``utils/log_utils.py``; reference
``robomimic/utils/log_utils.py``). TensorBoard and wandb are used only where
they are installed."""

import os
import sys
import time
from collections import defaultdict

_WARNINGS_BUFFER = []


class PrintLogger:
    """Tee stdout/stderr to a log file (reference log_utils.py:21-44)."""

    def __init__(self, log_file):
        self.terminal = sys.stdout
        self.log_file = open(log_file, "a")

    def write(self, message):
        self.terminal.write(message)
        try:
            self.log_file.write(message)
            self.log_file.flush()
        except ValueError:
            pass  # file closed

    def flush(self):
        self.terminal.flush()


class DataLogger:
    """Fan out scalars to tensorboard (tensorboardX) and wandb, with
    running-stats aggregation (reference log_utils.py:46-197). Both sinks
    are optional and gated on availability."""

    def __init__(self, log_dir, config, log_tb=True, log_wandb=False):
        self._tb_logger = None
        self._wandb_logger = None
        self._data = defaultdict(list)

        if log_tb:
            try:
                from tensorboardX import SummaryWriter

                self._tb_logger = SummaryWriter(
                    os.path.join(log_dir, "tb")
                )
            except ImportError:
                print("DataLogger: tensorboardX unavailable, skipping TB logs")

        if log_wandb:
            try:
                import wandb

                for attempt in range(10):  # retried init (reference :82-96)
                    try:
                        wandb.init(
                            project=config.experiment.logging.wandb_proj_name,
                            name=config.experiment.name,
                            dir=log_dir,
                            mode=os.environ.get("WANDB_MODE", "offline"),
                        )
                        try:
                            wandb.config.update(config.to_dict())
                        except Exception:
                            pass
                        self._wandb_logger = wandb
                        break
                    except Exception as e:
                        print(f"wandb init attempt {attempt} failed: {e}")
                        time.sleep(3)
            except ImportError:
                print("DataLogger: wandb unavailable, skipping wandb logs")

    def record(self, k, v, epoch, data_type="scalar", log_stats=False):
        assert data_type in ("scalar", "dict")
        if data_type == "scalar":
            if log_stats or k in self._data:
                self._data[k].append(v)
        if self._tb_logger is not None:
            if data_type == "scalar":
                self._tb_logger.add_scalar(k, v, epoch)
                if log_stats:
                    stats = self.get_stats(k)
                    for stat_k, stat_v in stats.items():
                        self._tb_logger.add_scalar(
                            f"{k}-{stat_k}", stat_v, epoch
                        )
            elif data_type == "dict":
                self._tb_logger.add_scalars(k, v, epoch)
        if self._wandb_logger is not None:
            try:
                if data_type == "scalar":
                    self._wandb_logger.log({k: v}, step=epoch)
                elif data_type == "dict":
                    self._wandb_logger.log(v, step=epoch)
            except Exception as e:
                print(f"wandb logging failed: {e}")

    def get_stats(self, k):
        import numpy as np

        return {
            "mean": float(np.mean(self._data[k])),
            "std": float(np.std(self._data[k])),
            "min": float(np.min(self._data[k])),
            "max": float(np.max(self._data[k])),
        }

    def close(self):
        if self._tb_logger is not None:
            self._tb_logger.close()
        if self._wandb_logger is not None:
            try:
                self._wandb_logger.finish()
            except Exception:
                pass


def log_warning(message, color="yellow", print_now=True):
    """Buffer warnings for a flush before training (reference :227-255)."""
    _WARNINGS_BUFFER.append(message)
    if print_now:
        print(f"WARNING: {message}")


def flush_warnings():
    global _WARNINGS_BUFFER
    if _WARNINGS_BUFFER:
        print("*" * 50)
        print("buffered warnings:")
        for m in _WARNINGS_BUFFER:
            print("  " + m)
        print("*" * 50)
    _WARNINGS_BUFFER = []


def custom_tqdm(iterable, **kwargs):
    try:
        from tqdm import tqdm

        return tqdm(iterable, ncols=80, **kwargs)
    except ImportError:
        return iterable
