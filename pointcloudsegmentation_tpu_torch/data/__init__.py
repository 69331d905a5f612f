"""Input pipeline pieces of the port (host data itself comes from the JAX
package's numpy-only ``data`` modules)."""
