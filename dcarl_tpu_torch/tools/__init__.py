"""The port's counterparts of the repository's ``tools/*.py``, each run
as ``python -m dcarl_tpu_torch.tools.<name>`` (on the card unless
``--device cpu``), each with a ``main(argv=None) -> int``."""
