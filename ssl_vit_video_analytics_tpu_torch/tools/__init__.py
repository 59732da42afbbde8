"""Tools of the port: the serving export (``export_serving``), the
importer of reference PyTorch checkpoints (``import_torch_checkpoint``),
and the dataset front end's split verifier (``verify_dataset``) and
environment report (``env_checker``).

    python -m ssl_vit_video_analytics_tpu_torch.tools.export_serving --config configs/dynamic.yaml
    python -m ssl_vit_video_analytics_tpu_torch.tools.import_torch_checkpoint \\
        --torch_ckpt ref.pth --out results/imported/best
"""
