"""The plain reference and the comparisons that decide `correct`; imports neither JAX nor either package of the repository."""
