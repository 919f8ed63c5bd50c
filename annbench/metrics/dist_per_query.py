"""Distance computations a query: the window's ``SearchStats`` total over
the queries it answered."""


def read(r: dict):
    st = r.get("search_stats")
    if st is None or st.n_queries == 0:
        return None
    return st.n_distance_computations / st.n_queries
