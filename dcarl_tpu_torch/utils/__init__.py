"""Host utilities of the port: checkpoints and the store's text history
(``utils/checkpoint.py``).  The JAX package's other utilities
(logging, monitors, the native host store) are not ported yet."""
