"""Launch helpers of the port: process grids (``mesh``), the roofline on
the H100's published peaks (``roofline``), the paper's dibella cell
(``dibella_cell``) and its dry run (``python -m
repro_torch.launch.dryrun --arch dibella``), and language-model serving
(``python -m repro_torch.launch.serve``) and training (``python -m
repro_torch.launch.train``)."""
