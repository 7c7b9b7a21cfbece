"""ETH3D-style evaluation and reconstruction comparison."""
