"""Assembly stages of the port: k-mers, counting, alignment, contigs,
consensus, the simulator and the end-to-end pipeline."""
