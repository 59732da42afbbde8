"""The dataset front end of the port: the counterparts of the repo's
``preprocess/*.py``, importing the port only, so that a machine without
JAX turns videos into the frame folders, ``packed_<size>.npy`` arrays and
split files that every entry of the port reads.

    python -m ssl_vit_video_analytics_tpu_torch.preprocess.standardize_structure --root data/UCF101
    python -m ssl_vit_video_analytics_tpu_torch.preprocess.extract_frames \\
        --video_root data/UCF101 --out_root data/UCF101_frames --size 112 --pack
    python -m ssl_vit_video_analytics_tpu_torch.preprocess.generate_splits_lazy \\
        --frame_root data/UCF101_frames --out_dir data/splits --prefix UCF101
    python -m ssl_vit_video_analytics_tpu_torch.tools.verify_dataset \\
        --splits data/splits/UCF101_train.txt --min_frames 16 --clean

or all of it through ``experiments/torch/run_full_pipeline_dataset.sh``.
Each keeps the flags, outputs and exit codes of its JAX counterpart.
"""
