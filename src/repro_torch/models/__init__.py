"""The paper's Table-1 models."""
