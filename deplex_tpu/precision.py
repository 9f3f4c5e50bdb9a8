"""The one matmul precision of the extraction and SLAM paths.

Every f32 contraction passes ``precision=HIGHEST``. On a GPU the default
precision may run float32 products in TF32, which keeps about three decimal
digits: that rounds the values a one-hot contraction selects, not only its
sums, and would change segment tables, merge refits and solver steps.
"""

import jax

HIGHEST = jax.lax.Precision.HIGHEST
