"""A module fixture for the port's parity tests: both packages build their
host tables with the NumPy builders.

The JAX package's native library (``path_tracer_tpu/_native``, compiled
with ``-march=native``) orders 38 of cornell_specular's 2,584 triangles
differently from the NumPy SAH builder, a near-tie in the SAH cost. The
port takes its own native builder by default, whose order need not be that
library's on every machine. So a test that holds the port's tables or
renders against the JAX package's builds both sides with
``native.available`` patched to False in both packages: the same builder
on both sides. ``tests/test_torch_native.py`` holds the native builders
against each other and against NumPy.
"""

import pytest

from path_tracer_tpu import native as jnative
from path_tracer_tpu_torch import native as tnative


@pytest.fixture(autouse=True, scope="module")
def numpy_builders():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        yield
