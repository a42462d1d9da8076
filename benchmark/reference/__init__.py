"""Plain PyTorch references of what the benchmark's cells compute: the SPH
step (``sph``) and the density-field frame (``raster``).  Nothing here
imports the program under test."""
