"""The reference's examples on the port: each a script run as
``python -m repro_torch.examples.<name>``, on the card by default."""
