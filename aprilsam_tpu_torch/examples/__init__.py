"""Runnable examples of the port: ``python -m aprilsam_tpu_torch.examples.<name>``
with ``tutorial``, ``graph_save_load`` or ``distributed_solve``; each takes
``--device`` (default the card)."""
