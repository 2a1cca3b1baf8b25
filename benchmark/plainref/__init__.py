"""The benchmark's plain reference: the port's descriptor build, key
search, query tail and store updates as eager plain torch, frozen, with
the kernels' plain twins in place of the kernels. It imports nothing of
the port, of JAX or of the JAX package."""
