"""Set-up of SMC fits: one temper step of the sampler on the fit's shapes
(its moves' value-and-gradient calls and its likelihood sweeps), and the
final sweep over the particles."""

import torch


def warm(spec, run: dict, seed: int):
    from pioran_tpu_torch.samplers.smc import run_smc

    prior, dev = spec.prior, spec.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    z0 = prior.to_unconstrained(prior.sample((run["num_particles"],), generator=gen,
                                             dtype=spec.dtype, device=dev))
    run_smc(lambda Z: spec.loglike_batch(prior.from_unconstrained(Z)),
            prior.unconstrained_logpdf, z0, gen, num_moves=run["num_moves"], max_steps=1,
            move=run["smc_move"])
    with torch.no_grad():
        spec.loglike_batch(prior.from_unconstrained(z0))
