"""The hand-written Hopper kernels: their build and binding (:mod:`.build`),
the fused cross-entropy (:mod:`.fused_ce`), the stencil kernel's entry points
(:mod:`.ops`) and oracles (:mod:`.ref`), and a deprecated shim
(:mod:`.race_stencil`)."""
