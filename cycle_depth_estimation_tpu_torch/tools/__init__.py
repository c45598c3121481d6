"""Command-line tools of the port (the JAX repository's ``tools/``, the
part ported so far): ``save_kitti`` and ``eval_kitti``."""
