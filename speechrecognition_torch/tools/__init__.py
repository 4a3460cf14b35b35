"""Tools around the models: t-SNE of the NN's activations."""
