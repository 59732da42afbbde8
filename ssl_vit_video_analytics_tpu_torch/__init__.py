"""ssl_vit_video_analytics_tpu_torch — the PyTorch/CUDA port of
``ssl_vit_video_analytics_tpu``, for NVIDIA Hopper (H100).

Subpackages mirror the JAX package (``data``, ``ops``, ``models``, ``train``,
``entry``, ``utils``, ``privacy``, ``federated``, and ``scripts`` for the
repo's probe scripts); the counterpart of a JAX module sits at the same
relative path. The port imports torch and numpy, never jax. Ported so far:
the early-exit serving path of the MobileViT-S video classifier
(``entry/run_dynamic.py``), pretraining pipelines A, B and C
(``entry/train_ssl.py``, ``entry/train_ssl_mae.py``, ``entry/train_mae.py``),
the finetune path (``entry/train_finetune.py``, ``entry/evaluate.py``), the
privacy layers and FedAvg (``entry/run_privacy.py``,
``entry/run_federated.py``), the two kernel probes
(``scripts/probe_dw.py``, ``scripts/probe_exp.py``) and the dataset front
end (``preprocess/``, ``tools/verify_dataset.py``). Every
Pallas kernel of the JAX package has a CUDA counterpart under
``ops/csrc/``, built by ``ops/kernel_build.py``.
"""
