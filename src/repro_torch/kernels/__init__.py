"""Build and binding of the hand-written Hopper kernels (:mod:`.build`)."""
