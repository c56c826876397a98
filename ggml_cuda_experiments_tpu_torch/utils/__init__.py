"""Platform selection and device facts for the port."""
