"""The kNN selection study on the card: the TPU study's pipelines
(``profiling/knn_pallas*.py``, ``knn_layout_micro.py``,
``knn_quad_micro.py``) with their Pallas bodies as one CUDA block top-k
(``ops/block_topk.py``). Entry point: ``python -m
point_slam_tpu_torch.profiling.knn_study``. Nothing runs at import."""
