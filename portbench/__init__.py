"""The benchmark of the PyTorch and CUDA port
(``stable_diffusion_videos_tpu_torch``): see ``portbench/run.py`` and
``BENCHMARK.json``."""
