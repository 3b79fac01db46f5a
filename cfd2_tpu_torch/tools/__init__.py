"""Workflow tools of the port: the host-mesh cache (``mesh_cache``), the
developed unstructured states (``make_developed_unstructured``) and the table
of full-size cases with the function that steps them (``developed_cases``).

Each is also a command: ``python -m cfd2_tpu_torch.tools.<module> ...``."""
