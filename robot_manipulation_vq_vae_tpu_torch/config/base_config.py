"""Base config class + registry + factory (copy of the JAX package's
``config/base_config.py``, so that the same JSON templates load unchanged).

Every ``BaseConfig`` subclass self-registers under its ``ALGO_NAME``;
``config_factory(algo_name)`` builds the default template, which external
JSON files then override through ``config.values_unlocked()`` (unknown keys
raise).
"""

from copy import deepcopy

from robot_manipulation_vq_vae_tpu_torch.config.config import Config

REGISTERED_CONFIGS = {}


def get_all_registered_configs():
    return deepcopy(REGISTERED_CONFIGS)


def config_factory(algo_name, dic=None):
    """Instantiate the registered config template for @algo_name.

    Args:
        algo_name (str): registered algorithm name (e.g. "icl_gmm_paper").
        dic (dict or None): if given, build the config directly from this
            dictionary instead of the class defaults (checkpoint restore path).
    """
    if algo_name not in REGISTERED_CONFIGS:
        raise ValueError(
            "Config for algo name '{}' not found. Registered: {}".format(
                algo_name, ", ".join(sorted(REGISTERED_CONFIGS))
            )
        )
    return REGISTERED_CONFIGS[algo_name](dict_to_load=dic)


class ConfigMeta(type):
    def __new__(mcls, name, bases, class_dict):
        cls = super().__new__(mcls, name, bases, class_dict)
        if name != "BaseConfig" and getattr(cls, "ALGO_NAME", None):
            REGISTERED_CONFIGS[cls.ALGO_NAME] = cls
        return cls


class BaseConfig(Config, metaclass=ConfigMeta):
    """Template config with the five standard sections:
    experiment / train / algo / observation / meta. After construction the
    config is key-locked, so JSON overrides with unknown keys raise.
    """

    ALGO_NAME = None

    def __init__(self, dict_to_load=None):
        if dict_to_load is not None:
            super().__init__(dict_to_load)
            return
        super().__init__()
        self.algo_name = type(self).ALGO_NAME
        self.experiment_config()
        self.train_config()
        self.algo_config()
        self.observation_config()
        self.meta_config()
        self.lock_keys()

    # ------------------------------------------------------------ sections
    def experiment_config(self):
        """Experiment settings: logging, saving, rollout eval cadence."""
        self.experiment.name = "test"
        self.experiment.validate = False
        self.experiment.logging.terminal_output_to_txt = True
        self.experiment.logging.log_tb = True
        self.experiment.logging.log_wandb = False
        self.experiment.logging.wandb_proj_name = "debug"

        self.experiment.mse.enabled = False
        self.experiment.mse.every_n_epochs = 50
        self.experiment.mse.on_save_ckpt = True
        self.experiment.mse.num_samples = 20
        self.experiment.mse.visualize = True

        self.experiment.save.enabled = True
        self.experiment.save.every_n_seconds = None
        self.experiment.save.every_n_epochs = 50
        self.experiment.save.epochs = []
        self.experiment.save.on_best_validation = False
        self.experiment.save.on_best_rollout_return = False
        self.experiment.save.on_best_rollout_success_rate = True
        self.experiment.save.format = "pickle"
        self.experiment.save.include_optimizer = False

        self.experiment.epoch_every_n_steps = 100
        self.experiment.validation_epoch_every_n_steps = 10

        self.experiment.env = None
        self.experiment.additional_envs = None

        self.experiment.render = False
        self.experiment.render_video = True
        self.experiment.keep_all_videos = False
        self.experiment.video_skip = 5

        self.experiment.rollout.enabled = True
        self.experiment.rollout.n = 50
        self.experiment.rollout.horizon = 400
        self.experiment.rollout.rate = 50
        self.experiment.rollout.warmstart = 0
        self.experiment.rollout.terminate_on_success = True
        self.experiment.rollout.batched = False
        self.experiment.rollout.num_batch_envs = 5

        self.experiment.env_meta_update_dict = Config()
        self.experiment.env_meta_update_dict.do_not_lock_keys()

        self.experiment.ckpt_path = None

    def train_config(self):
        """Training/data-loader settings. The speed-mode keys are kept so that
        the JAX package's JSON templates load; the port reads none of them."""
        self.train.data = None
        self.train.output_dir = "../{}_trained_models".format(self.algo_name)
        self.train.num_data_workers = 0
        self.train.hdf5_cache_mode = "all"
        self.train.hdf5_use_swmr = True
        self.train.hdf5_load_next_obs = True
        self.train.hdf5_normalize_obs = False
        self.train.hdf5_filter_key = None
        self.train.hdf5_validation_filter_key = None
        self.train.seq_length = 1
        self.train.pad_seq_length = True
        self.train.frame_stack = 1
        self.train.pad_frame_stack = True
        self.train.dataset_keys = ("actions", "rewards", "dones")
        self.train.action_keys = ["actions"]
        self.train.action_config = {}
        self.train.goal_mode = None
        self.train.cuda = True
        self.train.batch_size = 100
        self.train.num_epochs = 2000
        self.train.seed = 1
        self.train.max_grad_norm = None
        self.train.data_format = "robomimic"
        self.train.shuffled_obs_key_groups = None
        self.train.mixed_precision = False
        self.train.frozen_batch_norm = False
        self.train.pool_free_stem = False
        self.train.pallas_pool = False
        self.train.packed_rgb_encoders = False

    def algo_config(self):
        """Populated by subclasses."""
        pass

    def observation_config(self):
        """Observation modalities + per-modality encoder settings."""
        self.observation.modalities.obs.low_dim = [
            "robot0_eef_pos",
            "robot0_eef_quat",
            "robot0_gripper_qpos",
            "object",
        ]
        self.observation.modalities.obs.rgb = []
        self.observation.modalities.obs.depth = []
        self.observation.modalities.obs.scan = []
        self.observation.modalities.goal.low_dim = []
        self.observation.modalities.goal.rgb = []
        self.observation.modalities.goal.depth = []
        self.observation.modalities.goal.scan = []
        self.observation.modalities.obs.do_not_lock_keys()
        self.observation.modalities.goal.do_not_lock_keys()

        self.observation.encoder.low_dim.core_class = None
        self.observation.encoder.low_dim.core_kwargs = Config()
        self.observation.encoder.low_dim.core_kwargs.do_not_lock_keys()
        self.observation.encoder.low_dim.obs_randomizer_class = None
        self.observation.encoder.low_dim.obs_randomizer_kwargs = Config()
        self.observation.encoder.low_dim.obs_randomizer_kwargs.do_not_lock_keys()

        self.observation.encoder.rgb.core_class = "VisualCore"
        self.observation.encoder.rgb.core_kwargs = Config()
        self.observation.encoder.rgb.core_kwargs.do_not_lock_keys()
        self.observation.encoder.rgb.obs_randomizer_class = None
        self.observation.encoder.rgb.obs_randomizer_kwargs = Config()
        self.observation.encoder.rgb.obs_randomizer_kwargs.do_not_lock_keys()

        self.observation.encoder.do_not_lock_keys()

        self.observation.encoder.depth = deepcopy(self.observation.encoder.rgb)
        self.observation.encoder.scan = deepcopy(self.observation.encoder.rgb)
        self.observation.encoder.scan.core_class = "ScanCore"
        self.observation.encoder.scan.core_kwargs = Config()
        self.observation.encoder.scan.core_kwargs.do_not_lock_keys()

    def meta_config(self):
        """Hyperparameter-sweep job metadata."""
        self.meta.hp_base_config_file = None
        self.meta.hp_keys = []
        self.meta.hp_values = []

    # ---------------------------------------------------------- properties
    @property
    def use_goals(self):
        return (
            len(
                [
                    k
                    for modality in self.observation.modalities.goal.values()
                    for k in modality
                ]
            )
            > 0
        )

    @property
    def all_obs_keys(self):
        keys = set()
        for group in (
            self.observation.modalities.obs.values(),
            self.observation.modalities.goal.values(),
        ):
            for modality in group:
                keys.update(modality)
        return sorted(keys)
