"""The benchmark's own code: finding parts by name, the stand-in data,
the weights, the traced run's reduction, the result line."""
