"""Drivers: the general code that runs a traffic mix, one module per `driver` a mix names."""
