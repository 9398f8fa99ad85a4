"""The port's counterparts of the JAX package's ``examples/*.py``, each
run as ``python -m dcarl_tpu_torch.examples.<name>`` (on the card unless
``--device cpu``), each with a ``main(argv=None) -> int``."""
