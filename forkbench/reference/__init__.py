"""The benchmark's plain references, one module per architecture
(``model.py``: ``gqa_moe``), in plain PyTorch, float32.  None imports
anything of the program under test."""
