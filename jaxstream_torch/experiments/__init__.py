"""The router-free covariant steppers and the del^4 step-budget
bisection.

Counterpart of :mod:`jaxstream.experiments` (the two steppers, measured
negative results on the TPU; on the GPU the trade differs, and the port
measures them again) and of ``experiments/nu4_bisect.py``:

* :mod:`.swe_cov_nbr`: each RK stage fills its ghosts from the
  neighbour faces' interiors inside the kernel (three launches per step,
  no router, no strip carry);
* :mod:`.swe_mega`: the whole SSPRK3 step, routes included, in one
  cooperative launch over the compact carry;
* :mod:`.nu4_bisect`: the in-stage del^4 step timed lever by lever,
  with kernel B's ghost fill or Laplacian ablated (B14).
"""
