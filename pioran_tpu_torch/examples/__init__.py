"""Command-line scripts, one module for each of the JAX package's example
scripts, with their options and output layout:

- ``single_pl``, ``double_pl``, ``single_pl_periodicity``, ``carma``: fit
  one light curve (``python -m pioran_tpu_torch.examples.single_pl
  data.txt --sampler smc``);
- ``parity``: the posterior-parity runs against the reference's stored
  ultranest results and the importance-sampling referees, written to
  ``artifacts/torch_parity``.

Each has ``main(argv=None) -> int``; importing a module runs nothing.
"""
