"""Tools around the models: t-SNE of the NN's activations, and the AN4 LVCSR
system's LM matrices and decode (``an4_system``)."""
