"""PyTorch/CUDA port of the GAP-safe Sparse-Group Lasso package."""
