"""The two router-free covariant steppers.

Counterpart of :mod:`jaxstream.experiments`, where both are measured
negative results on the TPU; on the GPU the trade differs, and the port
measures them again:

* :mod:`.swe_cov_nbr`: each RK stage fills its ghosts from the
  neighbour faces' interiors inside the kernel (three launches per step,
  no router, no strip carry);
* :mod:`.swe_mega`: the whole SSPRK3 step, routes included, in one
  cooperative launch over the compact carry.
"""
