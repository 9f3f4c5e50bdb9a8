"""Serial numpy oracle of the CAPE plane-extraction pipeline.

This is NOT the device implementation — it is a slow, readable, serial
re-derivation of the reference semantics used as a conformance oracle in
tests (and to validate the golden label arrays generated from the reference
build). The device pipeline in ``deplex_tpu.pipeline`` is tested against both
this oracle and the stored reference goldens.
"""

from deplex_tpu.oracle.reference_impl import extract_planes_oracle

__all__ = ["extract_planes_oracle"]
