"""Sparse algebra of the port: dispatch seam, semirings, ELL matrices,
SpGEMM, string graph, transitive reduction and graph primitives."""
