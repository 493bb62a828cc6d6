"""pioran_tpu_torch: the PyTorch + CUDA port of pioran_tpu.

Scalable Gaussian-process power-spectral-density inference (bending
power-law PSDs of irregularly sampled light curves through O(N)
celerite likelihoods), on an NVIDIA H100. The JAX package ``pioran_tpu``
stays beside it as the reference. Ported so far: the PSD models, the
celerite kernel algebra, the PSD -> celerite approximation, the priors,
the batched celerite log-likelihood and its gradient (hand-written CUDA
kernels on the card, their plain PyTorch versions on the CPU), the
table-streaming likelihood (``ops.cuda_celerite.batched_loglike_tables``),
tempered SMC, nested sampling, NUTS, ChEES-HMC, ADVI, CARMA(p, q) models
(``models.carma``) and sinusoidal means (``models.gp.CustomMean``), the
model builders of the JAX package (single- and double-bending power laws,
a periodic signal in red noise, CARMA) with ``run_inference(sampler="smc"
| "ns" | "nuts" | "chees" | "advi")``, the multi-dataset axis:
``run_inference_many``
over ragged light curves on the ragged batched likelihood
``batched_loglike_multi``, the GP object API (``ScalableGP``,
``posterior``: log-likelihoods, prior draws, posterior means and
covariances, batched over GPs) and the post-fit diagnostics
(``run_diagnostics``, ``run_posterior_predict_checks``), checkpoint and
resume of NS and SMC runs (``checkpoint``, ``run_inference(resume=True)``)
and the multi-GPU particle and chain paths on ``torch.distributed``
(``parallel``, ``run_inference(mesh=...)``). Entry points run on the
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
from .ops.approx import (
    approx,
    approximated_psd,
    get_approx_coefficients,
)
from .ops import celerite as celerite_ops
from .ops import direct as direct_ops
from .models.gp import (
    ScalableGP,
    GaussianProcess,
    ConditionedGP,
    PosteriorGP,
    CustomMean,
    posterior,
)
from .models.carma import CARMA, quad2roots, roots2coeffs
from .ops.celerite import log_likelihood
from .priors import (
    TwoUniformDependent,
    ThreeUniformDependent,
    TwoLogUniformDependent,
)
from .utils.subset import extract_subset
from .diagnostics.approx_checks import run_diagnostics, sample_approx_model
from .diagnostics.ppc import run_posterior_predict_checks
from .ops.cuda_celerite import batched_loglike, batched_loglike_multi
from .inference import (
    advi_seeded_inits,
    single_bending_model,
    double_bending_model,
    periodic_rednoise_model,
    carma_model,
    run_inference,
    run_inference_many,
)

__version__ = "0.5.0"
