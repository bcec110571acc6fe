"""qmf_tpu — implicit-feedback matrix factorization framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++ library taozhijiang/qmf (see SURVEY.md at the repo root):

- WALS (weighted alternating least squares, Hu-Koren implicit feedback):
  the reference's per-row LAPACK ``dsysv_`` solves
  (reference: qmf/wals/WALSEngine.cpp:266-310) become degree-bucketed batched
  Gramian accumulation (batched einsums) feeding batched Cholesky solves
  over all users/items at once.
- BPR (Bayesian personalized ranking): the reference's Hogwild! lock-free SGD
  (reference: qmf/bpr/BPREngine.cpp:146-176) becomes synchronous vectorized
  minibatch SGD with on-device negative sampling and segment-sum gradient
  scatter.
- Ranking metrics (AUC, AP, P@k, R@k, MSE): full score-matrix matmul plus
  two-key sorts on device (reference: qmf/metrics/Metrics.cpp).
- Distribution: the reference's scheduler/labor TCP cluster (reference:
  distributed/) maps to SPMD sharding over a ``jax.sharding.Mesh`` with the
  fixed factor side replicated/all-gathered over NVLink, plus a thin task
  submission control plane.
"""

__version__ = "0.1.0"

from qmf_tpu.config import BPRConfig, MetricsConfig, WALSConfig  # noqa: F401
