"""pioran_tpu_torch: the PyTorch + CUDA port of pioran_tpu.

Scalable Gaussian-process power-spectral-density inference (bending
power-law PSDs of irregularly sampled light curves through O(N)
celerite likelihoods), on an NVIDIA H100. The JAX package ``pioran_tpu``
stays beside it as the reference. Ported so far: the PSD models, the
celerite kernel algebra, the PSD -> celerite approximation, the priors,
the batched celerite log-likelihood and its gradient (hand-written CUDA
kernels on the card, their plain PyTorch versions on the CPU), nested
sampling, ChEES-HMC, ADVI and the flagship single-bending model with
``run_inference(sampler="ns" | "chees" | "advi")``, and the multi-dataset
axis: ``run_inference_many`` over ragged light curves on the ragged
batched likelihood ``batched_loglike_multi``. Entry points run on the
card unless given ``device="cpu"``.
"""

from .config import require_cuda
from .models.psd import (
    PowerSpectralDensity,
    PowerLaw,
    SingleBendingPowerLaw,
    DoubleBendingPowerLaw,
    Lorentzian,
    QPO,
    SumPSD,
    separate_psd,
)
from .models.kernels import (
    CeleriteKernel,
    celerite_term,
    sho_term,
    exp_term,
    SHO,
    Exp,
    celerite_psd,
    celerite_covariance,
)
from .ops.approx import approx, get_approx_coefficients
from .priors import (
    TwoUniformDependent,
    ThreeUniformDependent,
    TwoLogUniformDependent,
)
from .ops.cuda_celerite import batched_loglike, batched_loglike_multi
from .inference import (
    advi_seeded_inits,
    single_bending_model,
    run_inference,
    run_inference_many,
)

__version__ = "0.5.0"
