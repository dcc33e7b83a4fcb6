"""Diffusion Policy with the conditional 1-D UNet (counterpart of the JAX
package's ``algo/diffusion_policy.py``), registered as ``diffusion_policy``.

The observation encoder (``nets["obs_encoder"]``) encodes the last
``observation_horizon`` (To) frames, each core's features through a ReLU,
and its ResNet trunks take GroupNorm(C // 16) for BatchNorm (the
reference's ``replace_bn_with_gn``: every modality's
``backbone_kwargs.norm`` is "group"). Their features [B, To * D] condition
the UNet (``nets["policy"]``), which predicts the noise added to the first
``prediction_horizon`` (Tp) actions at a random timestep of the DDPM
schedule; the loss is the mean squared error. The encoder and the UNet each
take their own optimizer from ``optim_params.policy`` (and their own
``train.max_grad_norm`` clipping).

With ``ema.enabled`` the shadows ``nets["policy_ema"]`` and
``nets["obs_encoder_ema"]`` follow each training step's parameters with the
decay min((1 + k) / (10 + k), 0.9999) at training step k (``ema.power`` is
read and unused, as in the JAX package). ``get_action`` encodes with the
live encoder, denoises pure noise with the UNet's shadow (DDPM, or DDIM with
``algo.ddim``) over the strided inference grid, and returns the action at
To - 1 of the denoised sequence; it denoises in full for every action, as
the JAX package does.

Seams for tests (draws in the JAX package's order): ``_noise_hook()``
returns a training step's (timesteps [B], noise [B, Tp, A]);
``_sample_hook()`` returns a request's (initial noise [B, Tp, A], the DDPM
steps' noises [n, B, Tp, A] or None). Otherwise both come from
``self.generator``.

Under data parallelism (``parallel.shard_state``) the gradients of both
networks are averaged over the ranks before each one's clipping, so the EMA
shadows stay equal on every rank; the training step's timesteps and noise
and a request's initial noise and DDPM noises are taken at the global
batch's shape (a hook's draws are the global batch's) and each rank keeps
its rows; a request returns the global batch's actions on every rank. The
GroupNorm trunks are per row; a BatchNorm trunk normalizes by the global
batch (``base_nets.global_batch_norm``).

``train.mixed_precision`` runs the training step as the JAX step's bf16
branch does (``algo/diffusion_policy.py``:167-213): the timesteps, the noise
and ``add_noise`` stay fp32; the encoder and the UNet run on bf16 copies of
their parameters (``utils/mixed_precision.half_call``), the encoder on bf16
observations and the UNet on the noisy actions cast to bf16 and the
encoder's condition as it comes; the predicted noise comes back fp32, and
the loss, both optimizers and the EMA are fp32 on the fp32 masters.
``get_action`` (DDPM / DDIM) stays fp32. Which layer computes in bf16 is
JAX's promotion, read off ``jax.make_jaxpr`` of the JAX bf16 step:

* bf16: the encoder's trunks and keypoint convolutions (GroupNorm's
  statistics and arithmetic fp32, one rounding to bf16; with
  low-dimensional observations alone the encoder has no layer), and the
  UNet's first residual block's first convolution, its GroupNorm and Mish,
  and its 1x1 residual convolution: they take the bf16 noisy actions;
* fp32 on bf16 parameters: the timestep MLP (the sinusoidal embedding is
  fp32), every FiLM projection of the condition (the timestep embedding
  makes it fp32), and from the first FiLM on (a bf16 feature map times an
  fp32 scale) every later convolution, GroupNorm, transposed convolution
  and the final convolution.
"""

import copy
from collections import OrderedDict

import torch

from robot_manipulation_vq_vae_tpu_torch.algo.algo import (
    PolicyAlgo,
    register_algo_factory_func,
)
from robot_manipulation_vq_vae_tpu_torch.models.diffusion_nets import (
    ConditionalUnet1D,
    DiffusionSchedule,
)
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import ObservationGroupEncoder
from robot_manipulation_vq_vae_tpu_torch.utils import mixed_precision as MixedPrecision
from robot_manipulation_vq_vae_tpu_torch.utils import obs_utils as ObsUtils
from robot_manipulation_vq_vae_tpu_torch.utils import optim_utils as OptimUtils
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw, keep_rows
from robot_manipulation_vq_vae_tpu_torch.utils.optim_utils import (
    clip_by_global_norm_,
)

NETS = ("policy", "obs_encoder")


@register_algo_factory_func("diffusion_policy")
def algo_config_to_class(algo_config):
    if not algo_config.unet.enabled:
        raise NotImplementedError("the diffusion policy needs algo.unet enabled")
    return DiffusionPolicyUNet, {}


def _schedule(cfg, ddim):
    """The DiffusionSchedule of the ``algo.ddpm`` or ``algo.ddim`` section."""
    if cfg.get("prediction_type", "epsilon") != "epsilon":
        raise NotImplementedError(f"prediction_type {cfg.prediction_type} is not ported")
    kwargs = dict(beta_schedule=cfg.get("beta_schedule", "squaredcos_cap_v2"),
                  clip_sample=cfg.get("clip_sample", True))
    if ddim:
        kwargs.update(set_alpha_to_one=cfg.get("set_alpha_to_one", True),
                      steps_offset=cfg.get("steps_offset", 0))
    return DiffusionSchedule(cfg.num_train_timesteps, **kwargs)


class DiffusionPolicyUNet(PolicyAlgo):
    """See the module docstring."""

    MIXED_PRECISION = True

    _noise_hook = None
    _sample_hook = None

    def _create_networks(self):
        cfg = self.algo_config
        self.To = cfg.horizon.observation_horizon
        self.Ta = cfg.horizon.action_horizon
        self.Tp = cfg.horizon.prediction_horizon
        self.nets["obs_encoder"] = ObservationGroupEncoder(
            [("obs", self.obs_shapes)], self._gn_encoder_kwargs(),
            feature_activation="relu")
        self.nets["policy"] = ConditionalUnet1D(
            input_dim=self.ac_dim,
            global_cond_dim=self.To * self.nets["obs_encoder"].output_dim,
            diffusion_step_embed_dim=cfg.unet.diffusion_step_embed_dim,
            down_dims=tuple(cfg.unet.down_dims),
            kernel_size=cfg.unet.kernel_size,
            n_groups=cfg.unet.n_groups,
        )
        if cfg.ddpm.enabled:
            self.schedule, self.use_ddim = _schedule(cfg.ddpm, False), False
            self.num_inference_steps = cfg.ddpm.num_inference_timesteps
        elif cfg.ddim.enabled:
            self.schedule, self.use_ddim = _schedule(cfg.ddim, True), True
            self.num_inference_steps = cfg.ddim.num_inference_timesteps
        else:
            raise ValueError("the diffusion policy needs algo.ddpm or algo.ddim enabled")
        self.ema_enabled = cfg.ema.enabled
        if self.ema_enabled:
            for name in NETS:
                shadow = copy.deepcopy(self.nets[name])
                shadow.requires_grad_(False)
                self.nets[f"{name}_ema"] = shadow
        self._action_check_done = False

    def _gn_encoder_kwargs(self):
        """The encoder kwargs with every trunk's ``backbone_kwargs.norm``
        "group"."""
        kwargs = ObsUtils.obs_encoder_kwargs_from_config(self.obs_config.encoder)
        for mod_cfg in kwargs.values():
            core_kwargs = dict(mod_cfg.get("core_kwargs") or {})
            core_kwargs["backbone_kwargs"] = {**(core_kwargs.get("backbone_kwargs") or {}),
                                              "norm": "group"}
            mod_cfg["core_kwargs"] = core_kwargs
        return kwargs

    def _create_optimizers(self):
        """An optimizer and schedule each for the UNet and the encoder, both
        from ``optim_params.policy`` (none for an encoder without parameters:
        low-dimensional observations alone)."""
        for name in self._trained_nets():
            self.optimizers[name], self.lr_schedulers[name] = (
                OptimUtils.optimizer_from_optim_params(
                    self.nets[name].parameters(), self.algo_config.optim_params.policy,
                    self._num_training_steps()))

    def _trained_nets(self):
        return [n for n in NETS if any(True for _ in self.nets[n].parameters())]

    def process_batch_for_training(self, batch):
        """obs[:, :To] and actions[:, :Tp]; the first batch's actions must lie
        in [-1, 1]."""
        actions = batch["actions"][:, :self.Tp]
        if not self._action_check_done:
            inside = (actions >= -1) & (actions <= 1)
            if not bool(inside.all()):
                raise ValueError('"actions" must be in range [-1,1] for Diffusion Policy! '
                                 "Check if hdf5_normalize_action is enabled.")
            self._action_check_done = True
        return {"obs": {k: v[:, :self.To] for k, v in batch["obs"].items()},
                "goal_obs": batch.get("goal_obs", None),
                "actions": actions}

    def _encode_cond(self, encoder, obs, generator=None, half=False):
        """[B, To, ...] observations -> the condition [B, To * D]; with
        @half on bf16 copies of the encoder's parameters and of @obs."""
        b, to = next(iter(obs.values())).shape[:2]
        flat = {k: v.reshape(b * to, *v.shape[2:]) for k, v in obs.items()}
        if half:
            return MixedPrecision.half_call(encoder, ({"obs": flat}, generator)).reshape(b, -1)
        return encoder({"obs": flat}, generator).reshape(b, -1)

    def _loss(self, batch):
        obs, actions = self._device_batch(batch)
        b = actions.shape[0]
        if self._noise_hook is not None:
            t, noise = (keep_rows(self._draw(v), self.dp) for v in self._noise_hook())
        else:
            gen, dev = self.generator, self.device
            t = global_draw(lambda s: torch.randint(
                0, self.schedule.num_train_timesteps, s, generator=gen, device=dev),
                (b,), self.dp)
            noise = global_draw(lambda s: torch.randn(s, generator=gen, device=dev,
                                                      dtype=actions.dtype),
                                actions.shape, self.dp)
        noisy = self.schedule.add_noise(actions, noise, t)
        generator = self.generator if self.nets.training else None
        half = self.mixed_precision
        cond = self._encode_cond(self.nets["obs_encoder"], obs, generator, half)
        if half:
            eps = MixedPrecision.half_call(self.nets["policy"],
                                           (noisy.to(MixedPrecision.HALF), t, cond),
                                           cast_inputs=False).float()
        else:
            eps = self.nets["policy"](noisy, t, cond)
        return OrderedDict(l2_loss=((eps - noise) ** 2).mean())

    def _train_step(self, batch):
        losses = self._loss(batch)
        nets = self._trained_nets()
        params = {n: list(self.nets[n].parameters()) for n in nets}
        flat = [p for n in nets for p in params[n]]
        grads = torch.autograd.grad(losses["l2_loss"], flat, allow_unused=True)
        grads = iter(self._sync_grads([torch.zeros_like(p) if g is None else g
                                    for p, g in zip(flat, grads)]))
        for name in nets:
            g = [next(grads) for _ in params[name]]
            if self.max_grad_norm is not None:
                clip_by_global_norm_(g, self.max_grad_norm, self.mp)
            self._step(name, params[name], g)
        if self.ema_enabled:
            k = self.global_step
            decay = min((1.0 + k) / (10.0 + k), 0.9999)
            with torch.no_grad():
                for name in nets:
                    for e, p in zip(self.nets[f"{name}_ema"].parameters(), params[name]):
                        e.mul_(decay).add_(p, alpha=1.0 - decay)
        return OrderedDict((k, v.detach()) for k, v in losses.items())

    def _validate_step(self, batch):
        return self._loss(batch)

    def log_info(self, info):
        return OrderedDict(Loss=float(info["losses"]["l2_loss"]))

    def _sample(self, cond):
        """Denoise pure noise into an action sequence [B, Tp, A] with the
        UNet's shadow (the UNet itself without EMA)."""
        unet = self.nets["policy_ema" if self.ema_enabled else "policy"]
        shape = (cond.shape[0], self.Tp, self.ac_dim)
        draws = None if self._sample_hook is None else self._sample_hook()

        def normal():
            return global_draw(lambda s: torch.randn(s, generator=self.generator,
                                                     device=self.device, dtype=cond.dtype),
                               shape, self.dp)

        if draws is None:
            x = normal()
        else:
            x = keep_rows(self._draw(draws[0]), self.dp)
        sched = self.schedule
        stride = sched.num_train_timesteps // min(self.num_inference_steps,
                                                  sched.num_train_timesteps)
        for i, t in enumerate(sched.inference_timesteps(self.num_inference_steps,
                                                        self.use_ddim)):
            t = int(t)
            eps = unet(x, torch.full((shape[0],), t, device=self.device), cond)
            if self.use_ddim:
                x = sched.ddim_step(x, eps, t, t - stride)
                continue
            noise = (normal() if draws is None
                     else keep_rows(self._draw(draws[1][i]), self.dp))
            x = sched.ddpm_step(x, eps, t, t - stride, noise)
        return x

    @torch.inference_mode()
    def get_action(self, obs_dict, goal_dict=None):
        """The action of one request: observations [B, T >= To, ...] (the
        last To frames are encoded; fewer raise) -> [B, A], the denoised
        sequence's step To - 1; under data parallelism the global batch's,
        on every rank."""
        self._check_obs_request(obs_dict, goal_dict)
        for k, v in obs_dict.items():
            frame = self.obs_shapes.get(k)
            if frame is not None and (v.ndim != len(frame) + 2 or v.shape[1] < self.To):
                raise ValueError(
                    f"{k}: {tuple(v.shape)} holds no window of observation_horizon = "
                    f"{self.To} frames [B, T >= {self.To}, *{tuple(frame)}] (roll out with "
                    f"train.frame_stack >= {self.To})")
        obs = self._obs({k: v[:, -self.To:] for k, v in obs_dict.items()})
        cond = self._encode_cond(self.nets["obs_encoder"], obs)
        return self._gather_rows(self._sample(cond)[:, self.To - 1])
