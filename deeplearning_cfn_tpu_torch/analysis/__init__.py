"""Analysis helpers of the port (what the serving plane needs of them)."""
