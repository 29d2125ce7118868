"""The benchmark's plain reference: the GraphTCN and its edge classifier,
their losses, clip + Adam, the radius graph and DBSCAN, in plain PyTorch
and NumPy. It imports nothing of the program; it takes the weights and
events that the benchmark made and works out everything else (the EC cut's
edges, the condensation subsample, the neighbour graph) itself."""
