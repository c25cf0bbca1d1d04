"""Physical constants (counterpart of :mod:`jaxstream.config`).

Only the Earth constants the shallow-water path needs; the YAML run
schema of the JAX package comes with the port of ``simulation.py``.
"""

EARTH_RADIUS = 6.37122e6
EARTH_OMEGA = 7.292e-5
EARTH_GRAVITY = 9.80616
