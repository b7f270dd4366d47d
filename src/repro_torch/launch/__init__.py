"""Entry points of the PyTorch port: ``serve`` runs the sharded
transaction runtime's serving loop on one device (``python -m
repro_torch.launch.serve``); ``train`` trains an LM (``python -m
repro_torch.launch.train``)."""
