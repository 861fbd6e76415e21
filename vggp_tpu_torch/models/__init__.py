"""Models of the port: the SVGP (``svgp``), the collapsed GP over any
feature family (``sgpr``), the exact GP (``exact``), and the collapsed
families of the additive (``additive``), sum-of-kernels (``sum``) and
free-point (``freesvgp``) models; ``common`` holds what they share."""
