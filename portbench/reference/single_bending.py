"""Plain reference of ``single_bending_model`` (its default priors, no flux
offset): theta = (alpha_1, alpha_2, f_1, variance, nu, mu), and the
parameter rows the traffic draws around a referee posterior."""

from __future__ import annotations

import math

import torch

from portbench.reference.celerite import (LOG2PI, ApproxCelerite, gamma_logpdf,
                                          log_sig_pair, lognormal_logpdf)


class Model(ApproxCelerite):
    """The single-bending power law's log-posterior."""

    def psd(self, points, TH):
        # pioran_tpu_torch/models/psd.py:88 (SingleBendingPowerLaw.__call__)
        a1, f1, a2 = TH[:, 0], TH[:, 2], TH[:, 1]
        x = points / f1[:, None]
        return x ** (-a1[:, None]) / (1.0 + x ** (a2[:, None] - a1[:, None]))

    # -- prior (priors.py:236 TwoUniformDependent, :118 LogUniform, :160 LogNormal,
    #    :206 Gamma, :146 Normal; PriorSet.from_unconstrained :403)
    def theta(self, Z):
        s0, s1 = torch.sigmoid(Z[:, 0]), torch.sigmoid(Z[:, 1])
        a1 = 1.5 * s0
        a2 = a1 + (4.0 - a1) * s1
        la, lb = math.log(self.f_lo_b), math.log(self.f_hi_b)
        f1 = torch.exp(la + torch.sigmoid(Z[:, 2]) * (lb - la))
        return torch.stack([a1, a2, f1, torch.exp(Z[:, 3]), torch.exp(Z[:, 4]), Z[:, 5]], dim=1)

    def log_prior_u(self, Z):
        """The prior's log-density in unconstrained space
        (PriorSet.unconstrained_logpdf, priors.py:407)."""
        lp = log_sig_pair(Z[:, 0]) + log_sig_pair(Z[:, 1]) + log_sig_pair(Z[:, 2])
        lp = lp + lognormal_logpdf(torch.exp(Z[:, 3]), -3.0, math.sqrt(2.0)) + Z[:, 3]
        lp = lp + gamma_logpdf(torch.exp(Z[:, 4]), 2.0, 0.5) + Z[:, 4]
        zz = (Z[:, 5] - self.mu0) / self.mu_sd
        return lp - 0.5 * zz**2 - math.log(self.mu_sd) - 0.5 * LOG2PI

    def logpost(self, Z):
        return self.log_prior_u(Z) + self.loglike(self.theta(Z))


def rows(model: Model, referee: dict, n: int, sd: float, gen: torch.Generator, dtype, device):
    """n theta rows scattered ``sd`` referee standard deviations around the
    referee mean, clamped inside the prior's support (a copy of
    chip_smoke.py:329, referee_thetas)."""
    mean = torch.tensor(referee["is_mean"], dtype=dtype, device=device)
    std = torch.tensor(referee["is_std"], dtype=dtype, device=device)
    th = mean + sd * std * torch.randn((n, 6), generator=gen, dtype=dtype, device=device)
    th[:, 0] = th[:, 0].clamp(0.01, 1.49)
    th[:, 1] = torch.maximum(th[:, 1], th[:, 0] + 0.01).clamp(max=3.99)
    th[:, 2] = th[:, 2].clamp(model.f_lo_b * 1.01, model.f_hi_b * 0.99)
    th[:, 3] = th[:, 3].clamp(min=1e-4)
    th[:, 4] = th[:, 4].clamp(min=0.2)
    return th
