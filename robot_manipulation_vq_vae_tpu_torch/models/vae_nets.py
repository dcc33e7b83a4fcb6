"""The conditional VAE actor (counterpart of the JAX package's
``models/vae_nets.py``): ``vae_args_from_config`` and ``VAEActor``, with the
reference's priors: N(0, I); a learned Gaussian or Gaussian mixture,
optionally conditioned on the observations; and a categorical prior sampled
by Gumbel-softmax, soft or hard (straight-through).

The encoder ``q_net`` reads [observation features, actions]; the decoder
``decoder_net`` reads [observation features, z] (or z alone without
``decoder_is_conditioned``) and its reconstruction is tanh-squashed. The
random draws come from a ``torch.Generator`` or are injected: the training
forward's ``eps`` (the standard normal of the reparametrization, or the
uniform of the Gumbel noise under the categorical prior) and the prior's
sample (``prior_draws``), so that a test can feed both frameworks the same
noise.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from robot_manipulation_vq_vae_tpu_torch.models import base_nets as BaseNets
from robot_manipulation_vq_vae_tpu_torch.models.obs_nets import ObservationGroupEncoder
from robot_manipulation_vq_vae_tpu_torch.models.policy_nets import _groups, _inputs
from robot_manipulation_vq_vae_tpu_torch.utils import loss_utils as LossUtils
from robot_manipulation_vq_vae_tpu_torch.utils.draws import global_draw, take_rows


def vae_args_from_config(vae_config):
    """``algo.vae.*`` as ``VAEActor``'s keyword arguments."""
    return dict(
        encoder_layer_dims=tuple(vae_config.encoder_layer_dims),
        decoder_layer_dims=tuple(vae_config.decoder_layer_dims),
        latent_dim=vae_config.latent_dim,
        latent_clip=vae_config.latent_clip,
        decoder_is_conditioned=vae_config.decoder.is_conditioned,
        decoder_reconstruction_sum_across_elements=(
            vae_config.decoder.reconstruction_sum_across_elements),
        prior_learn=vae_config.prior.learn,
        prior_is_conditioned=vae_config.prior.is_conditioned,
        prior_layer_dims=tuple(vae_config.prior_layer_dims),
        prior_use_gmm=vae_config.prior.use_gmm,
        prior_gmm_num_modes=vae_config.prior.gmm_num_modes,
        prior_gmm_learn_weights=vae_config.prior.gmm_learn_weights,
        prior_use_categorical=vae_config.prior.use_categorical,
        prior_categorical_dim=vae_config.prior.categorical_dim,
        prior_categorical_gumbel_softmax_hard=(
            vae_config.prior.categorical_gumbel_softmax_hard),
    )


class VAEActor(nn.Module):
    """CVAE over actions [B, A] conditioned on observations [B, ...]."""

    JAX_NAMES = {"obs_encoder": "obs_encoder", "q_net": "q_net",
                 "decoder_net": "decoder_net"}
    # the data-parallel axis (``parallel.AxisComm``): the draws are taken
    # at the global batch's shape and each rank keeps its rows
    # (``utils.draws.global_draw``), set by ``parallel.shard_state``
    dp = None

    def __init__(self, obs_shapes, ac_dim, encoder_layer_dims=(300, 400),
                 decoder_layer_dims=(300, 400), latent_dim=14, latent_clip=None,
                 decoder_is_conditioned=True,
                 decoder_reconstruction_sum_across_elements=False, prior_learn=False,
                 prior_is_conditioned=False, prior_layer_dims=(300, 400),
                 prior_use_gmm=False, prior_gmm_num_modes=10,
                 prior_gmm_learn_weights=False, prior_use_categorical=False,
                 prior_categorical_dim=10, prior_categorical_gumbel_softmax_hard=False,
                 goal_shapes=None, encoder_kwargs=None):
        super().__init__()
        self.ac_dim = ac_dim
        self.goal_shapes = goal_shapes
        self.latent_dim = latent_dim
        self.latent_clip = latent_clip
        self.decoder_is_conditioned = decoder_is_conditioned
        self.sum_across_elements = decoder_reconstruction_sum_across_elements
        self.prior_learn = prior_learn
        self.prior_is_conditioned = prior_is_conditioned
        self.categorical = prior_use_categorical
        self.categorical_dim = prior_categorical_dim
        self.gumbel_hard = prior_categorical_gumbel_softmax_hard
        self.num_modes = prior_gmm_num_modes if prior_use_gmm else 1
        self.use_gmm = prior_use_gmm
        self.learn_weights = prior_use_gmm and prior_gmm_learn_weights
        self.obs_encoder = ObservationGroupEncoder(_groups(obs_shapes, goal_shapes),
                                                   encoder_kwargs, feature_activation="relu")
        feat = self.obs_encoder.output_dim
        z_dim = latent_dim * prior_categorical_dim if self.categorical else latent_dim
        self.q_net = BaseNets.MLP(feat + ac_dim,
                                  z_dim if self.categorical else 2 * latent_dim,
                                  encoder_layer_dims)
        self.decoder_net = BaseNets.MLP(
            (feat if decoder_is_conditioned else 0) + z_dim, ac_dim, decoder_layer_dims)
        self.prior_net = None
        if prior_learn and not self.categorical:
            out = 2 * latent_dim * self.num_modes + (self.num_modes if self.learn_weights
                                                     else 0)
            # an unconditioned prior reads a constant zero feature
            self.prior_net = BaseNets.MLP(feat if prior_is_conditioned else 1, out,
                                          prior_layer_dims)
            self.JAX_NAMES = {**self.JAX_NAMES, "prior_net": "prior_net"}

    def obs_features(self, obs_dict, goal_dict=None, generator=None):
        return self.obs_encoder(
            _inputs(obs_dict, goal_dict, self.goal_shapes, over_time=False), generator)

    def encode(self, actions, obs_feat):
        """The posterior's parameters: {"logits": [B, latent, K]} under the
        categorical prior, else {"mean", "logvar": [B, latent]}."""
        out = self.q_net(torch.cat([obs_feat, actions], dim=-1))
        if self.categorical:
            return {"logits": out.reshape(*out.shape[:-1], self.latent_dim,
                                          self.categorical_dim)}
        mean, logvar = out.chunk(2, dim=-1)
        return {"mean": mean, "logvar": logvar}

    def _clip(self, z):
        if self.latent_clip is None:
            return z
        return z.clamp(-self.latent_clip, self.latent_clip)

    def reparametrize(self, params, temperature=1.0, eps=None, generator=None):
        """z from the posterior: Gumbel-softmax of the logits at
        @temperature (@eps the uniform draw [B, latent, K]), or mean +
        exp(logvar / 2) @eps (the standard-normal draw), clipped to
        ``latent_clip``."""
        if self.categorical:
            logits = params["logits"]
            if eps is None:
                eps = global_draw(lambda s: torch.rand(
                    s, generator=generator, device=logits.device, dtype=logits.dtype),
                    logits.shape, self.dp)
            g = -torch.log(-torch.log(eps + 1e-20) + 1e-20)
            y = torch.softmax((logits + g) / temperature, dim=-1)
            if self.gumbel_hard:
                hard = F.one_hot(y.argmax(-1), self.categorical_dim).to(y.dtype)
                y = hard + y - y.detach()
            return y.reshape(*y.shape[:-2], -1)
        mean = params["mean"]
        if eps is None:
            eps = global_draw(lambda s: torch.randn(
                s, generator=generator, device=mean.device, dtype=mean.dtype),
                mean.shape, self.dp)
        return self._clip(mean + torch.exp(0.5 * params["logvar"]) * eps)

    def decode(self, z, obs_feat):
        h = torch.cat([obs_feat, z], dim=-1) if self.decoder_is_conditioned else z
        return torch.tanh(self.decoder_net(h))

    def _prior_params(self, obs_feat):
        """The learned prior's (means, logvars [B, M, latent], log weights
        [B, M]), or None for N(0, I)."""
        if self.prior_net is None:
            return None
        b, m, d = obs_feat.shape[0], self.num_modes, self.latent_dim
        if self.prior_is_conditioned:
            raw = self.prior_net(obs_feat)
        else:
            raw = self.prior_net(torch.zeros_like(obs_feat[:, :1])).expand(b, -1)
        means = raw[..., :d * m].reshape(b, m, d)
        logvars = raw[..., d * m:2 * d * m].reshape(b, m, d)
        if self.learn_weights:
            logw = torch.log_softmax(raw[..., -m:], dim=-1)
        else:
            logw = torch.full((b, m), -math.log(m), dtype=raw.dtype, device=raw.device)
        return means, logvars, logw

    def kl(self, params, z, obs_feat):
        """The KL term: exact against N(0, I), a learned Gaussian or the
        uniform categorical; a one-sample estimate E_q[log q(z) - log p(z)]
        against a Gaussian mixture."""
        if self.categorical:
            logits = params["logits"]
            q = torch.softmax(logits, dim=-1)
            log_q = torch.log_softmax(logits, dim=-1)
            return (q * (log_q + math.log(float(self.categorical_dim)))).sum((-2, -1)).mean()
        prior = self._prior_params(obs_feat)
        if prior is None:
            return LossUtils.kld_0_1_loss(params["mean"], params["logvar"])
        means, logvars, logw = prior
        if not self.use_gmm:
            return LossUtils.kld_gaussian_loss(params["mean"], params["logvar"],
                                               means[:, 0], logvars[:, 0])
        log_qz = LossUtils.log_normal(z, params["mean"], params["logvar"].exp())
        log_pz = LossUtils.log_normal_mixture(z, means, logvars.exp(), logw)
        return (log_qz - log_pz).mean()

    def forward_train(self, actions, obs_dict, goal_dict=None, temperature=1.0, eps=None,
                      generator=None):
        """The reference's training outputs: the reconstruction, the KL and
        reconstruction losses, z and the posterior's parameters."""
        obs_feat = self.obs_features(obs_dict, goal_dict, generator)
        params = self.encode(actions, obs_feat)
        z = self.reparametrize(params, temperature, eps, generator)
        recons = self.decode(z, obs_feat)
        sq = (recons - actions) ** 2
        recon_loss = sq.sum(-1).mean() if self.sum_across_elements else sq.mean()
        return {"decoder_outputs": recons, "kl_loss": self.kl(params, z, obs_feat),
                "reconstruction_loss": recon_loss, "encoder_z": z,
                "encoder_params": params}

    def sample_prior(self, obs_feat, generator=None, draws=None):
        """z from the prior. @draws injects its raw draws, in the JAX
        package's order: the categorical prior's indices [B, latent]; N(0,
        I)'s standard normal [B, latent]; a learned prior's (component [B],
        standard normal [B, latent]). Under data parallelism the draws are
        the global batch's and B this rank's rows (injected draws too: the
        caller keeps its rows)."""
        b, dev, dtype = obs_feat.shape[0], obs_feat.device, obs_feat.dtype
        def normal_draw():
            return global_draw(lambda s: torch.randn(s, generator=generator, device=dev,
                                                     dtype=dtype),
                               (b, self.latent_dim), self.dp)

        if self.categorical:
            idx = draws if draws is not None else global_draw(
                lambda s: torch.randint(0, self.categorical_dim, s, generator=generator,
                                        device=dev), (b, self.latent_dim), self.dp)
            return F.one_hot(idx.long(), self.categorical_dim).to(dtype).reshape(b, -1)
        prior = self._prior_params(obs_feat)
        if prior is None:
            normal = draws if draws is not None else normal_draw()
            return self._clip(normal)
        means, logvars, logw = prior
        if draws is None:
            # the mixture's component over the global batch's weights (the
            # categorical draw is not separable by rows), this rank's rows kept
            weights = logw.exp() if self.dp is None else self.dp.all_gather(logw.exp())
            mode = torch.multinomial(weights, 1, generator=generator)[:, 0]
            if self.dp is not None:
                mode = take_rows(mode, self.dp.rank, self.dp.size, False)
            normal = normal_draw()
        else:
            mode, normal = draws
        index = mode.long()[:, None, None].expand(b, 1, self.latent_dim)
        mean = means.gather(1, index)[:, 0]
        logvar = logvars.gather(1, index)[:, 0]
        return self._clip(mean + torch.exp(0.5 * logvar) * normal)

    def forward(self, obs_dict, goal_dict=None, generator=None, prior_draws=None):
        """An action [B, A]: the decoding of a prior sample."""
        obs_feat = self.obs_features(obs_dict, goal_dict, generator)
        return self.decode(self.sample_prior(obs_feat, generator, prior_draws), obs_feat)
