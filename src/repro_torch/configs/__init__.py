"""Search configurations of the port."""
