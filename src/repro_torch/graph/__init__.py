"""Graph substrate: the destination-sorted container and Table-2 datasets."""
