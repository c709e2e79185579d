"""Framework configuration shared by the port's modules (copy of the reference's ``_internal``)."""
