"""Layer IR: specs, layers and the net compiler."""
