"""The RL algorithm family (``dcarl_tpu/algos``).

The reference vendors a stable-baselines fork (TF1, ~25.9k LoC) whose
algorithms define the capability surface its DCARL agent server runs on
(software/src/tools/DCARL/stable_baselines/: A2C, ACER, ACKTR, PPO1,
PPO2, DDPG, SAC, TD3, TRPO, GAIL, HER, DQN).  Here each algorithm is a
functional PyTorch learner: ``make_<algo>()`` returns ``init_fn``,
``update_fn`` and, where the JAX package has one, ``act_fn`` over an
explicit state NamedTuple of tensors, so every learner

* batches over the vectorized envs on the device (no SubprocVecEnv),
* data-parallelizes over a ``ProcessMesh`` (pass ``mesh``: gradients
  are averaged in one all-reduce, the MpiAdam replacement,
  common/mpi_adam.py:8-121),
* checkpoints as plain tensors (the SB save/load contract,
  common/base_class.py).

A ``torch.Generator`` on the state's device takes the place of the JAX
key.  Each ``update_fn`` also exposes ``update_fn.draw(state,
generator)``, the raw draws one update takes, and
``update_fn.with_draws(state, draws)``, the same update on given draws.
"""

from dcarl_tpu_torch.algos import common  # noqa: F401
