"""PyTorch/CUDA port of ``repro`` (asynchronous stochastic-gradient MCMC
with elastic coupling).  It imports torch, never jax, and nothing of the
reference package; its subpackages mirror the reference's layout.

Ported so far: serving the K-member posterior-predictive ensemble of the
dense and hybrid models (``serve.engine.ServeEngine``), refreshed live from
background chains (``serve.engine.ChainRefresher`` and the overlapped
``RefreshScheduler`` on a side CUDA stream), and drawing it: elastically
coupled SGHMC chains (``core.ec_sghmc``) and the adaptive tier, run by the
chunked executor (``run``) and the training loop (``train``) with
checkpoints (``train.checkpoint``); the launchers ``launch.serve`` and
``launch.train``.  Hand-written Hopper kernels (``kernels``) do flash
prefill attention, paged decode attention, the fused BMA mixture + token
selection, the fused Eq. 6 chain updates and the RG-LRU scan.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""
