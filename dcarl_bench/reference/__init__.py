"""The plain reference of the benchmark's cells: PyTorch tensor code that
imports nothing of the port (nor JAX), written from the semantics of the
reference scenario (zhcao92/DCARL: ``RLS.py``'s box query, Welch gate
and trajectory records; the ``AttentionQNet`` DQN's TD step)."""
