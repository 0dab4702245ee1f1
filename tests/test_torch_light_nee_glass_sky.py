"""Area-light NEE in the port's lockstep against the JAX package's, on the
CPU, where it meets the other switches of the megakernel's bounce body:
the glass box (glass lanes take no NEE), the Cornell box under the sky
with env NEE and light NEE in one bounce, and a 320-triangle dragon in
the Cornell shell (over the kernel's brute tier: B1e+d on the card), at
`tests/light_nee_cases.py`'s bound (its 1-in-256 allowance covers the
mesh scene's FMA, see test_torch_intersect.py)."""

import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)

from light_nee_cases import check_frame_matches_jax


@pytest.mark.parametrize("name", ["dragon_320", "glass_box",
                                  "sky_env_light"])
def test_light_nee_frame_matches_jax(name):
    check_frame_matches_jax(name)
