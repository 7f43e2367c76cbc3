"""Demo models: the reference's three example renderers as Demo classes.

- :class:`TrigDemo` — hello-triangle with camera (examples/trig.rs)
- :class:`BonsaiDemo` — fragment-raymarch of the 256^3 CT volume
  (examples/bonsai/)
- :class:`XorDemo` — compute raymarch of the procedural fbm volume with
  single/tile dispatch modes and pass timing (examples/xor/)
"""

from vokselis.models.trig import TrigDemo
from vokselis.models.bonsai import BonsaiDemo
from vokselis.models.xor import XorDemo

__all__ = ["TrigDemo", "BonsaiDemo", "XorDemo"]
